"""The port end to end against the JAX package's ``jit`` engine.

Both engines query byte-identical catalogs (the port's is carried across
with ``catalog_from_arrays``), and must return the same rows in the same
order and finish with the same capacity vector: the WatDiv basic suite
at two scales (the first instance of each template; at the second scale
only those whose capacities grow there and not at the first), the pinned
differential corpus at τ ∈ {0.25, 1.0}, and the modifier and UNBOUND
queries the ``jit`` engine answers.  Also: batches equal the same
queries run one by one, re-binding constants builds no new executor, and
a constant missing from the dictionary is answered from statistics."""

import numpy as np
import pytest

from repro.engine import Dataset as RDataset
from repro.rdf.workloads import basic_queries

from repro_torch import Dataset
from repro_torch.core.jexec import PlanExecutor
from repro_torch.engine.engine import Engine

from test_differential import FIXED_QUERIES, fixed_corpus_triples
from test_modifiers import TRIPLES as MOD_TRIPLES
from test_torch_data import port_catalog
from test_unbound import TRIPLES as UNBOUND_TRIPLES


def twin(rds):
    """The port's CPU dataset over exactly the reference's catalog."""
    return Dataset(catalog=port_catalog(rds.catalog), device="cpu")


def assert_same(ref_eng, port_eng, qtext):
    r = ref_eng.query(qtext)
    t = port_eng.query(qtext)
    assert r.cols == t.cols, qtext
    assert t.data.dtype == np.int32
    np.testing.assert_array_equal(r.data, t.data, err_msg=qtext)
    rp, tp = ref_eng.prepare(qtext), port_eng.prepare(qtext)
    assert hasattr(rp, "executor") == hasattr(tp, "executor"), qtext
    if hasattr(tp, "executor"):
        assert tp.executor.caps == list(rp.executor.caps), qtext
    return t


SCALES = (0.1, 0.3)


@pytest.fixture(scope="module", params=SCALES,
                ids=[f"scale{s}" for s in SCALES])
def watdiv(request):
    rds = RDataset.watdiv(scale=request.param, seed=0, threshold=0.25)
    return rds, twin(rds), request.param


def _grown(ds, schema):
    """Basic templates (first instances) whose capacities grow on the
    port over ``ds``; the port runs them on a fresh engine."""
    eng = Engine(ds, device=ds.device)
    out = {}
    for name, insts in basic_queries(schema, seed=0).items():
        prepared = eng.prepare(insts[0])
        if not hasattr(prepared, "executor"):
            continue
        seeded = list(prepared.executor.caps)
        eng.query(insts[0])
        if prepared.executor.caps != seeded:
            out[name] = insts[0]
    return out


def test_basic_suite_matches_jit(watdiv):
    """The whole suite at the first scale.  At the second, only the
    templates whose capacities grow there and not at the first (the
    overflow-retry paths the larger graph adds) are held against the
    reference, which keeps its per-template XLA compiles few."""
    rds, ds, scale = watdiv
    ref_eng, eng = rds.engine("jit"), ds.engine()
    queries = {name: insts[0] for name, insts in
               basic_queries(rds.schema, seed=0).items()}
    if scale != SCALES[0]:
        first = Dataset.watdiv(scale=SCALES[0], seed=0, threshold=0.25,
                               device="cpu")
        known = _grown(first, first.schema)
        queries = {name: q for name, q in _grown(ds, rds.schema).items()
                   if name not in known}
        assert queries
    rows = 0
    for qtext in queries.values():
        rows += len(assert_same(ref_eng, eng, qtext))
    assert rows > 0
    assert eng.metrics.device_fallbacks == 0


def test_basic_batch_equals_one_by_one(watdiv):
    rds, ds, _ = watdiv
    eng = ds.engine()
    for name, insts in basic_queries(rds.schema, seed=0).items():
        single = [eng.query(q) for q in insts]
        batched = eng.query_batch(insts + insts[:1])
        for a, b in zip(single + single[:1], batched):
            assert a.cols == b.cols
            np.testing.assert_array_equal(a.data, b.data, err_msg=name)


@pytest.mark.parametrize("tau", [0.25, 1.0])
def test_fixed_corpus_matches_jit(tau):
    rds = RDataset.from_triples(fixed_corpus_triples(), threshold=tau)
    ds = twin(rds)
    ref_eng, eng = rds.engine("jit"), ds.engine()
    for qtext in FIXED_QUERIES:
        assert_same(ref_eng, eng, qtext)
    assert ref_eng.metrics.device_fallbacks == 0
    assert eng.metrics.device_fallbacks == 0


MODIFIER_QUERIES = [
    "SELECT DISTINCT ?x WHERE { ?p ex:price ?x } ORDER BY ?x LIMIT 2",
    "SELECT DISTINCT ?x WHERE { ?p ex:price ?x } ORDER BY DESC(?x) LIMIT 2",
    "SELECT ?u ?x WHERE { ?u ex:likes ?p . ?p ex:price ?x } "
    "ORDER BY ?x ?u LIMIT 2 OFFSET 1",
    "SELECT DISTINCT ?x WHERE { ?p ex:price ?x }",
    "SELECT ?x WHERE { ?p ex:price ?x } LIMIT 0",
    "SELECT ?x WHERE { ?p ex:price ?x } OFFSET 99",
    "SELECT * WHERE { ?u ex:likes ?p . ?p ex:price ?x FILTER(?x < 25) }",
    "SELECT * WHERE { ?u ex:likes ?p . ?p ex:price ?x "
    "FILTER(?x < 25 && ?x > 5) }",
    "SELECT ?u WHERE { ?u ex:likes ?p . ?p ex:price ?x "
    "FILTER(!(?x = 10) || BOUND(?u)) }",
    "SELECT ?u ?x WHERE { ?u ex:likes ?p . ?p ex:price ?x "
    "FILTER(?u != ex:u2) } ORDER BY DESC(?x)",
    "SELECT DISTINCT ?x WHERE { ?u ex:likes ?p . ?p ex:price ?x "
    "FILTER(?x >= 10) } ORDER BY ?x OFFSET 1",
    "SELECT ?p WHERE { ?p ex:price ?x } ORDER BY DESC(?x)",
    "SELECT DISTINCT ?x WHERE { ex:u1 ex:likes ?p . ?p ex:price ?x } "
    "ORDER BY ?x",
    "SELECT ?x WHERE { ?p ex:price ?x } ORDER BY ?x LIMIT 1",
    "SELECT * WHERE { ?u ex:likes ?p OPTIONAL { ?p ex:price ?x } }",
]

UNBOUND_QUERIES = [
    "SELECT * WHERE { ?s p0 ?o OPTIONAL { ?o p1 ?w } }",
    "SELECT DISTINCT ?w WHERE { ?s p0 ?o OPTIONAL { ?o p1 ?w } }",
    "SELECT * WHERE { ?s p0 ?o OPTIONAL { ?o p1 ?w } } ORDER BY ?w",
    "SELECT * WHERE { ?s p0 ?o OPTIONAL { ?o p1 ?w } } ORDER BY DESC(?w)",
]


@pytest.mark.parametrize("triples,queries", [
    (MOD_TRIPLES, MODIFIER_QUERIES), (UNBOUND_TRIPLES, UNBOUND_QUERIES),
    ([("ex:a", "ex:p", '"16777217"'), ("ex:b", "ex:p", '"16777216"')],
     ["SELECT ?s WHERE { ?s ex:p ?x FILTER(?x > 16777216) }",
      "SELECT ?s ?x WHERE { ?s ex:p ?x } ORDER BY ?x",
      "SELECT ?s ?x WHERE { ?s ex:p ?x } ORDER BY DESC(?x)"]),
], ids=["modifiers", "unbound", "two-pow-24"])
def test_modifier_and_unbound_queries_match_jit(triples, queries):
    rds = RDataset.from_triples(triples)
    ds = twin(rds)
    ref_eng, eng = rds.engine("jit"), ds.engine()
    for qtext in queries:
        assert_same(ref_eng, eng, qtext)


def test_two_pow_24_values_order_exactly():
    ds = Dataset.from_triples([("ex:a", "ex:p", '"16777217"'),
                               ("ex:b", "ex:p", '"16777216"')], device="cpu")
    eng = ds.engine()
    res = eng.query("SELECT ?s WHERE { ?s ex:p ?x FILTER(?x > 16777216) }")
    assert res.to_terms() == [{"?s": "ex:a"}]
    res = eng.query("SELECT ?s ?x WHERE { ?s ex:p ?x } ORDER BY ?x")
    assert [m["?x"] for m in res.to_terms()] == ['"16777216"', '"16777217"']


def _user_query(u):
    return (f"SELECT DISTINCT ?x WHERE {{ ex:u{u} ex:likes ?p . "
            f"?p ex:price ?x }} ORDER BY ?x")


def test_rebinding_builds_no_new_executor(monkeypatch):
    ds = Dataset.from_triples(MOD_TRIPLES, device="cpu")
    eng = ds.engine()
    built = []
    orig = PlanExecutor.__init__

    def counting(self, *a, **k):
        built.append(1)
        orig(self, *a, **k)

    monkeypatch.setattr(PlanExecutor, "__init__", counting)
    first = eng.query(_user_query(1))
    second = eng.query(_user_query(2))
    eng.query_batch([_user_query(1), _user_query(2), _user_query(1)])
    assert len(built) == 1 and len(eng.cache) == 1
    assert [m["?x"] for m in first.to_terms()] == ['"10"', '"30"']
    assert [m["?x"] for m in second.to_terms()] == ['"10"', '"20"']


def test_missing_constant_short_circuits():
    ds = Dataset.from_triples(MOD_TRIPLES, device="cpu")
    eng = ds.engine()
    eng.query(_user_query(1))
    prepared = eng.prepare(_user_query(1))

    def fail(*a, **k):
        raise AssertionError("the executor ran for a missing constant")

    prepared.executor.run = fail
    prepared.executor.run_batch = fail
    res = eng.query(_user_query(999))
    assert len(res) == 0 and res.cols == ("?x",)
    out = eng.query_batch([_user_query(999), _user_query(998)])
    assert [len(r) for r in out] == [0, 0]


def test_unported_paths_raise_and_are_counted():
    """The host-only ``pt`` layout no longer raises: it is served through
    the flagged eager fallback, cached, and counted per request, as the
    reference's ``jit`` engine does."""
    rds = RDataset.from_triples(MOD_TRIPLES)
    ds = Dataset.from_triples(MOD_TRIPLES, device="cpu")
    eng = ds.engine(layout="pt")
    q = "SELECT * WHERE { ?u ex:likes ?p }"
    want = rds.engine("jit", layout="pt").query(q)
    for _ in range(2):
        got = eng.query(q)
        assert got.cols == want.cols
        np.testing.assert_array_equal(got.data, want.data)
    assert eng.metrics.device_fallbacks == 2
    assert len(eng.cache) == 1
