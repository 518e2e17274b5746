"""The port end to end against the JAX package's ``jit`` engine.

Both engines query byte-identical catalogs (the port's is carried across
with ``catalog_from_arrays``), and must return the same rows in the same
order and finish with the same capacity vector: the WatDiv basic suite
at two scales (the first instance of each template; at the second scale
only those whose capacities grow there and not at the first), the pinned
differential corpus at τ ∈ {0.25, 1.0}, and the modifier and UNBOUND
queries the ``jit`` engine answers.  Also: batches equal the same
queries run one by one, re-binding constants builds no new executor, and
a constant missing from the dictionary in a required triple pattern is
answered from statistics.  A constant missing anywhere else (under
OPTIONAL, in a UNION branch, in a FILTER) is where the port departs from
``jit``: it runs the query and returns the oracle's rows, where ``jit``
returns none (``test_reference_jit_empties_answers_the_oracle_keeps``)."""

import numpy as np
import pytest

from repro.engine import Dataset as RDataset
from repro.rdf.workloads import basic_queries

from repro_torch import Dataset, Result
from repro_torch.core.executor import Bindings
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


#: the triples and queries of the missing-constant repair: each query
#: holds a constant absent from the dictionary (``ex:e99``, ``"lit"``)
#: outside its required patterns, so SPARQL keeps the 2 rows of
#: ``?s ex:pa ?o``
REPAIR_TRIPLES = [("ex:e0", "ex:pa", "ex:e1"), ("ex:e1", "ex:pa", "ex:e2"),
                  ("ex:e2", "ex:pb", "ex:e0"), ("ex:e1", "ex:pb", "ex:e3")]
REPAIR_QUERIES = [
    "SELECT * WHERE { ?s ex:pa ?o OPTIONAL { ?o ex:pb ex:e99 } }",
    "SELECT * WHERE { { ?s ex:pa ?o } UNION { ?s ex:pb ex:e99 } }",
    "SELECT * WHERE { ?s ex:pa ?o FILTER(?o != ex:e99) }",
    'SELECT * WHERE { ?s ex:pa ?o FILTER(?o != "lit") }',
]

#: more places for the missing constant, each held against the oracle:
#: a FILTER constant that matches no row reads as such under =, !=, <
#: and negation, and inside an OPTIONAL's condition
REPAIR_MORE = [
    "SELECT * WHERE { ?s ex:pa ?o FILTER(?o = ex:e99) }",
    "SELECT * WHERE { ?s ex:pa ?o FILTER(!(?o = ex:e99)) }",
    "SELECT * WHERE { ?s ex:pa ?o FILTER(?o < ex:e99 || ?s != ex:e98) }",
    "SELECT * WHERE { ?s ex:pa ?o "
    "OPTIONAL { ?o ex:pb ?w FILTER(?w != ex:e99) } }",
    "SELECT * WHERE { ?s ex:pa ?o OPTIONAL { ex:e99 ex:pb ?w } }",
]


def _oracle(rds, qtext):
    from repro.core.reference import execute_reference, mappings_to_multiset
    from repro.core.sparql import parse_sparql
    d = rds.dictionary
    got = execute_reference(parse_sparql(qtext, d), rds.catalog.tt, d.values)
    return mappings_to_multiset(got, ["?o", "?s", "?w"])


def _bag(cols, data):
    res = Result(Bindings(tuple(cols), np.asarray(data)), None)
    return dict(res.as_multiset(["?o", "?s", "?w"]))


@pytest.mark.parametrize("backend", ["eager", "torch"])
def test_missing_constant_outside_required_patterns_runs(backend):
    """The four queries of the repair return the oracle's 2 rows, single
    and batched (a batch mixing them with an instance whose missing
    constant is required, which alone is empty)."""
    rds = RDataset.from_triples(REPAIR_TRIPLES)
    eng = Dataset.from_triples(REPAIR_TRIPLES, device="cpu").engine(backend)
    required = "SELECT * WHERE { ?s ex:pa ex:e99 . ?s ex:pa ?o }"
    for qtext in REPAIR_QUERIES:
        want = _oracle(rds, qtext)
        assert sum(want.values()) == 2
        one = eng.query(qtext)
        assert _bag(one.cols, one.data) == want, qtext
        batch = eng.query_batch([qtext, required, qtext])
        assert [len(r) for r in batch] == [2, 0, 2], qtext
        assert _bag(batch[2].cols, batch[2].data) == want, qtext
    # only the required case is a statistics-only answer
    assert eng.metrics.short_circuits == len(REPAIR_QUERIES)
    for qtext in REPAIR_MORE:
        want = _oracle(rds, qtext)
        for got in [eng.query(qtext)] + eng.query_batch([qtext, qtext]):
            assert _bag(got.cols, got.data) == want, qtext


def test_missing_constant_outside_required_patterns_runs_distributed(
        tmp_path):
    from _torch_dist_jobs import run_group
    rds = RDataset.from_triples(REPAIR_TRIPLES)
    queries = REPAIR_QUERIES + REPAIR_MORE + REPAIR_QUERIES[::-1]
    for rank in run_group("queries", 2, tmp_path, triples=REPAIR_TRIPLES,
                          queries=queries):
        for qtext, one, batched in zip(queries, rank["single"],
                                       rank["batched"]):
            want = _oracle(rds, qtext)
            assert _bag(one["cols"], one["data"]) == want, qtext
            assert _bag(batched["cols"], batched["data"]) == want, qtext


def test_reference_jit_empties_answers_the_oracle_keeps():
    """The named divergence: the reference's ``jit`` and ``eager``
    engines empty the whole answer when any constant is missing from the
    dictionary (``src/repro/engine/backends.py``), where its own oracle
    and the port keep the rows.  The port's parity tests against ``jit``
    therefore hold such queries against the oracle instead."""
    rds = RDataset.from_triples(REPAIR_TRIPLES)
    eng = Dataset.from_triples(REPAIR_TRIPLES, device="cpu").engine()
    for qtext in REPAIR_QUERIES:
        assert len(rds.engine("jit").query(qtext)) == 0, qtext
        assert len(rds.engine("eager").query(qtext)) == 0, qtext
        assert sum(_oracle(rds, qtext).values()) == 2, qtext
        assert len(eng.query(qtext)) == 2, qtext


def test_concrete_template_with_a_missing_predicate():
    """A predicate constant with a digit is a template slot in predicate
    position, so the template is served concrete (``QueryTemplate.
    concrete``) with ``MISSING_TERM`` as its predicate: the compiler
    prunes the OPTIONAL or UNION branch and keeps the rest; in a
    required pattern it empties the answer without running."""
    rds = RDataset.from_triples(REPAIR_TRIPLES)
    ds = Dataset.from_triples(REPAIR_TRIPLES, device="cpu")
    cases = {
        "SELECT * WHERE { ?s ex:pa ?o OPTIONAL { ?o ex:p9 ?w } }": 2,
        "SELECT * WHERE { { ?s ex:pa ?o } UNION { ?s ex:p9 ?o } }": 2,
        "SELECT * WHERE { ?s ex:pa ?o . ?o ex:p9 ?w }": 0,
    }
    for backend in ("eager", "torch"):
        eng = ds.engine(backend)
        for qtext, n in cases.items():
            prepared = eng.prepare(qtext)
            assert not prepared.template.rebindable, qtext
            res = eng.query(qtext)
            assert len(res) == n, (backend, qtext)
            assert _bag(res.cols, res.data) == _oracle(rds, qtext), \
                (backend, qtext)
            assert [len(r) for r in eng.query_batch([qtext, qtext])] == \
                [n, n], (backend, qtext)


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


# ---------------------------------------------------------------------------
# The facade's extension point: the backend registry (the counterparts of
# tests/test_engine_api.py's registry tests) and Dataset.query
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_pair(watdiv_small):
    cat, d, sch = watdiv_small
    rds = RDataset(catalog=cat, dictionary=d, schema=sch)
    return rds, twin(rds)


def test_builtin_backends_registered():
    from repro.engine import available_backends as ref_available
    from repro_torch.engine import available_backends
    # the reference's one-device backend is "jit", the port's "torch"
    assert ref_available() == ["distributed", "eager", "jit"]
    assert available_backends() == ["distributed", "eager", "torch"]


def test_unknown_backend_rejected_as_the_reference(small_pair):
    from repro.engine import create_backend as ref_create
    from repro_torch.engine import create_backend
    rds, ds = small_pair
    with pytest.raises(ValueError, match="unknown backend") as want:
        rds.engine("no-such-engine").query("SELECT * WHERE { ?s ?p ?o }")
    with pytest.raises(ValueError, match="unknown backend") as got:
        ds.engine("no-such-engine").query("SELECT * WHERE { ?s ?p ?o }")
    ref_msg, port_msg = str(want.value), str(got.value)
    assert ref_msg.split(";")[0] == port_msg.split(";")[0] == \
        "unknown backend 'no-such-engine'"
    with pytest.raises(ValueError) as direct:
        create_backend("no-such-engine")
    with pytest.raises(ValueError) as ref_direct:
        ref_create("no-such-engine")
    assert str(direct.value).split(";")[0] == \
        str(ref_direct.value).split(";")[0]


def test_custom_backend_pluggable(small_pair):
    """A registered backend is served by ``Engine`` by name with no
    call-site change, as the reference's; its answer equals the
    reference's eager engine's."""
    from repro_torch.engine import (
        ExecutionBackend, create_backend, register_backend,
    )
    from repro_torch.engine import backends as _b
    rds, ds = small_pair
    eager = create_backend("eager")

    class Probe(ExecutionBackend):
        name = "probe"
        prepared = 0

        def prepare(self, template, ctx):
            Probe.prepared += 1
            return eager.prepare(template, ctx)

    register_backend("probe", Probe)
    try:
        q = "SELECT * WHERE { ?u wsdbm:follows ?v }"
        eng = ds.engine("probe")
        assert eng.backend == "probe"
        res = eng.query(q)
        eng.query(q)
        assert len(res) > 0
        assert Probe.prepared == 1
        want = rds.engine("eager").query(q)
        assert res.cols == want.cols
        assert res.as_multiset() == want.as_multiset()
    finally:
        _b._REGISTRY.pop("probe", None)


def test_dataset_query_one_shot(small_pair):
    """``Dataset.query`` is ``ds.engine(backend).query(qtext)``, as the
    reference's; the answer equals the reference's jit engine's."""
    rds, ds = small_pair
    q = "SELECT * WHERE { ?u wsdbm:follows ?v . ?v wsdbm:likes ?p }"
    got = ds.query(q, device="cpu")
    want = rds.query(q, backend="jit")
    assert got.cols == want.cols
    np.testing.assert_array_equal(got.data, want.data)
    eager = ds.query(q, backend="eager")
    assert sorted(map(tuple, eager.data.tolist())) == \
        sorted(map(tuple, rds.query(q).data.tolist()))
