"""The port's host engine against the JAX package's, exactly.

``repro_torch.core.executor`` (the numpy eager executor),
``repro_torch.core.pt`` (the Sempala-style property-table baseline) and
``repro_torch.core.reference`` (the brute-force oracle) are copies of
``repro``'s modules.  Here the same inputs go through both packages and
the outputs must be equal — columns, rows and row order, tolerance none:

* the operators (scans, natural / left-outer joins, unions, filters,
  ORDER BY, stable DISTINCT, the modifier spine) on seeded relations with
  UNBOUND values, duplicate keys and several shared variables;
* ``execute`` under every layout (``extvp``, ``vp``, ``tt``, ``pt``) and
  ``execute_reference`` on ``tests/test_differential.py``'s random
  corpus (BGP, FILTER, OPTIONAL, UNION, unbound predicates, modifier
  spines) and on the WatDiv basic suite at scale 0.3;
* the ``"eager"`` engines of both packages, single and batched;
* a template whose numeric keys defeat the double-single encoding is
  served on the port's torch engine through the flagged eager fallback,
  as on the reference's ``jit`` engine.
"""

import numpy as np
import pytest

from repro.core import executor as RX
from repro.core import pt as RPT
from repro.core import reference as RREF
from repro.core.algebra import Bound as RBound
from repro.core.algebra import Cmp as RCmp
from repro.core.modifiers import ModifierSpine as RSpine
from repro.core.sparql import parse_sparql as rparse
from repro.engine import Dataset as RDataset
from repro.engine import RuntimeConfig as RRuntimeConfig
from repro.rdf.workloads import basic_queries

from repro_torch import Dataset
from repro_torch.core import executor as TX
from repro_torch.core import pt as TPT
from repro_torch.core import reference as TREF
from repro_torch.core.algebra import Bound as TBound
from repro_torch.core.algebra import Cmp as TCmp
from repro_torch.core.modifiers import ModifierSpine as TSpine
from repro_torch.core.sparql import parse_sparql as tparse

from test_differential import (
    assert_matches_oracle, random_query, random_triples,
)
from test_torch_data import port_catalog

LAYOUTS = ("extvp", "vp", "tt", "pt")
SEEDS = (5, 11, 23, 37, 53, 71, 89, 113, 149, 181, 211, 257)
QUERIES_PER_GRAPH = 4
UNBOUND = -1


def same_bindings(r, t, ctx=None):
    assert tuple(t.cols) == tuple(r.cols), ctx
    assert t.data.dtype == np.int32, ctx
    np.testing.assert_array_equal(t.data, r.data, err_msg=str(ctx))


def both_bindings(cols, data):
    return RX.Bindings(tuple(cols), data.copy()), \
        TX.Bindings(tuple(cols), data.copy())


def _rel(rng, n, k, hi=6, unbound=0.1):
    data = rng.integers(0, hi, (n, k)).astype(np.int32)
    data[rng.random((n, k)) < unbound] = UNBOUND
    return data


class _Dict:
    """A stand-in dictionary: the numeric value table is all the
    operators read of it."""

    def __init__(self, values):
        self.values = values


class _Cat:
    def __init__(self, values):
        self.dictionary = _Dict(values)


# ---------------------------------------------------------------- operators

@pytest.mark.parametrize("seed", range(8))
def test_joins_and_union_match_reference(seed):
    rng = np.random.default_rng(seed)
    shapes = [(("?a", "?b"), ("?b", "?c")),            # one shared var
              (("?a", "?b", "?c"), ("?c", "?b", "?d")),  # two shared
              (("?a", "?b", "?c"), ("?c", "?a", "?b")),  # three: filter
              (("?a",), ("?b",))]                        # cross product
    values = rng.normal(0.0, 10.0, 8)
    values[rng.random(8) < 0.3] = np.nan
    rcat, tcat = _Cat(values), _Cat(values)
    for acols, bcols in shapes:
        ra, ta = both_bindings(acols, _rel(rng, int(rng.integers(0, 30)),
                                           len(acols)))
        rb, tb = both_bindings(bcols, _rel(rng, int(rng.integers(0, 30)),
                                           len(bcols)))
        r_out, r_prov = RX.natural_join(ra, rb, return_provenance=True)
        t_out, t_prov = TX.natural_join(ta, tb, return_provenance=True)
        same_bindings(r_out, t_out, (seed, acols, bcols))
        np.testing.assert_array_equal(t_prov, r_prov)
        assert TX.join_count(ta, tb) == len(r_out), (seed, acols, bcols)
        expr = RCmp("!=", acols[0], bcols[-1]), TCmp("!=", acols[0],
                                                    bcols[-1])
        for re_, te in ((None, None), expr):
            same_bindings(RX.left_outer_join(ra, rb, re_, rcat),
                          TX.left_outer_join(ta, tb, te, tcat),
                          (seed, "left", acols, bcols))
        same_bindings(RX.union(ra, rb), TX.union(ta, tb), (seed, "union"))


@pytest.mark.parametrize("seed", range(6))
def test_filters_order_distinct_and_spine_match_reference(seed):
    rng = np.random.default_rng(100 + seed)
    values = np.where(rng.random(10) < 0.4, np.nan,
                      rng.integers(-5, 5, 10).astype(np.float64))
    rcat, tcat = _Cat(values), _Cat(values)
    cols = ("?a", "?b", "?c")
    ra, ta = both_bindings(cols, _rel(rng, 40, 3, hi=10, unbound=0.2))
    exprs = [(RCmp("<", "?a", "?b"), TCmp("<", "?a", "?b")),
             (RCmp(">=", "?a", 1.5), TCmp(">=", "?a", 1.5)),
             (RCmp("=", "?b", 3), TCmp("=", "?b", 3)),
             (RCmp("!=", "?c", "?zz"), TCmp("!=", "?c", "?zz")),
             (RBound("?c"), TBound("?c"))]
    for re_, te in exprs:
        np.testing.assert_array_equal(TX.eval_filter(te, ta, tcat),
                                      RX.eval_filter(re_, ra, rcat))
    for keys in ([("?a", True)], [("?c", False), ("?a", True)],
                 [("?zz", True)]):
        same_bindings(RX.order_rows(ra, keys, rcat),
                      TX.order_rows(ta, keys, tcat), keys)
    np.testing.assert_array_equal(TX.stable_unique_rows(ta.data[:, :2]),
                                  RX.stable_unique_rows(ra.data[:, :2]))
    for kw in (dict(filters=(exprs[0],), order=(("?b", False),),
                    project=("?b", "?a"), distinct=True, limit=5, offset=1),
               dict(order=(("?c", True),), project=("?c",), distinct=True),
               dict(limit=0), dict(offset=3)):
        rkw = dict(kw, filters=tuple(e[0] for e in kw.get("filters", ())))
        tkw = dict(kw, filters=tuple(e[1] for e in kw.get("filters", ())))
        same_bindings(RX.apply_spine_host(ra, RSpine(**rkw), rcat),
                      TX.apply_spine_host(ta, TSpine(**tkw), tcat), kw)


# --------------------------------------------------------- random corpus

def _corpus(seed):
    rng = np.random.default_rng(seed)
    n_ent = int(rng.integers(4, 16))
    n_preds = int(rng.integers(1, 4))
    triples = random_triples(rng, n_ent, n_preds, int(rng.integers(4, 50)))
    tau = (0.25, 1.0)[SEEDS.index(seed) % 2]
    queries = [random_query(rng, n_ent, n_preds)
               for _ in range(QUERIES_PER_GRAPH)]
    return triples, tau, queries


def _execute_both(rcat, tcat, qtext, layout):
    rq = rparse(qtext, rcat.dictionary)
    tq = tparse(qtext, tcat.dictionary)
    return RX.execute(rq, rcat, layout), TX.execute(tq, tcat, layout)


@pytest.mark.parametrize("seed", SEEDS)
def test_execute_every_layout_matches_reference(seed):
    triples, tau, queries = _corpus(seed)
    rds = RDataset.from_triples(triples, threshold=tau)
    rcat = rds.catalog
    tcat = port_catalog(rcat)
    for qtext in queries:
        for layout in LAYOUTS:
            r, t = _execute_both(rcat, tcat, qtext, layout)
            same_bindings(r, t, (seed, layout, qtext))
        # the oracle, mapping for mapping and in order
        rq = rparse(qtext, rcat.dictionary)
        tq = tparse(qtext, tcat.dictionary)
        want = RREF.execute_reference(rq, rcat.tt, rcat.dictionary.values)
        got = TREF.execute_reference(tq, tcat.tt, tcat.dictionary.values)
        assert got == want, (seed, qtext)
        cols = sorted({c for m in want for c in m})
        assert TREF.mappings_to_multiset(got, cols) == \
            RREF.mappings_to_multiset(want, cols)


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_eager_engine_matches_reference_eager(seed):
    """The ``"eager"`` engines of both packages on the same catalog:
    rows in order, single and batched, each also held against the
    oracle by the reference's rules."""
    triples, tau, queries = _corpus(seed)
    rds = RDataset.from_triples(triples, threshold=tau)
    ds = Dataset(catalog=port_catalog(rds.catalog), device="cpu")
    for layout in ("extvp", "pt"):
        ref = rds.engine("eager", layout=layout,
                         runtime=RRuntimeConfig(verify_plans=False))
        eng = ds.engine("eager", layout=layout)
        for qtext in queries:
            r, t = ref.query(qtext), eng.query(qtext)
            same_bindings(r.bindings, t.bindings, (seed, layout, qtext))
            assert_matches_oracle(t, qtext, rds.dictionary, rds.catalog.tt,
                                  (seed, layout))
        for qtext, r, t in zip(queries, ref.query_batch(queries),
                               eng.query_batch(queries)):
            same_bindings(r.bindings, t.bindings, (seed, "batch", qtext))
        assert eng.metrics.device_fallbacks == 0
        assert eng.metrics.routed == {"eager": 2 * len(queries)}


# ------------------------------------------------------------ WatDiv suite

@pytest.fixture(scope="module")
def watdiv():
    rds = RDataset.watdiv(scale=0.3, seed=0, threshold=0.25)
    return rds, port_catalog(rds.catalog)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_watdiv_basic_suite_matches_reference(watdiv, layout):
    rds, tcat = watdiv
    rows = 0
    for name, insts in basic_queries(rds.schema, seed=0).items():
        for qtext in insts[:2]:
            r, t = _execute_both(rds.catalog, tcat, qtext, layout)
            same_bindings(r, t, (name, layout, qtext))
            rows += len(t)
    assert rows > 0


def test_pt_star_groups_and_row_filter_match_reference(watdiv):
    rds, tcat = watdiv
    for name, insts in basic_queries(rds.schema, seed=0).items():
        rq = rparse(insts[0], rds.dictionary)
        tq = tparse(insts[0], tcat.dictionary)
        rg = RPT._star_groups(list(rq.root.patterns)) \
            if hasattr(rq.root, "patterns") else []
        tg = TPT._star_groups(list(tq.root.patterns)) \
            if hasattr(tq.root, "patterns") else []
        assert [[str(tp) for tp in g] for g in tg] == \
            [[str(tp) for tp in g] for g in rg], name
        for r_grp, t_grp in zip(rg, tg):
            np.testing.assert_array_equal(
                TPT._subject_intersection(t_grp, tcat),
                RPT._subject_intersection(r_grp, rds.catalog))


# ------------------------------------------------------- numeric-key fallback

NUMERIC_TRIPLES = [("ex:a", "ex:p", '"1.0000000298023224"'),
                   ("ex:b", "ex:p", '"1.0000000298023226"'),
                   ("ex:c", "ex:p", '"2.5"')]
NUMERIC_QUERY = "SELECT ?s ?x WHERE { ?s ex:p ?x } ORDER BY DESC(?x)"


def test_numeric_keys_fall_back_to_eager_like_jit():
    """Two values that differ only past the double-single encoding's 48
    bits make the torch executor raise NotImplementedError at prepare;
    the backend then prepares the flagged eager fallback, which answers
    exactly and is counted per request — the reference's ``jit`` does
    the same."""
    rds = RDataset.from_triples(NUMERIC_TRIPLES)
    ds = Dataset(catalog=port_catalog(rds.catalog), device="cpu")
    ref = rds.engine("jit", runtime=RRuntimeConfig(verify_plans=False))
    eng = ds.engine()
    for _ in range(2):
        r, t = ref.query(NUMERIC_QUERY), eng.query(NUMERIC_QUERY)
        same_bindings(r.bindings, t.bindings)
    assert [m["?s"] for m in t.to_terms()] == ["ex:c", "ex:b", "ex:a"]
    prepared = eng.prepare(NUMERIC_QUERY)
    assert prepared.fallback and prepared.backend == "eager"
    assert eng.metrics.device_fallbacks == ref.metrics.device_fallbacks == 2
    out = eng.query_batch([NUMERIC_QUERY, "SELECT * WHERE { ?s ex:p ?x }"])
    same_bindings(out[0].bindings, t.bindings)
    assert len(out[1]) == 3 and eng.metrics.device_fallbacks == 3


def test_eager_engine_reads_loaded_and_appended_host_tables(tmp_path):
    """The eager path needs the catalog's host tables on every dataset:
    after a lazy ``Dataset.load`` (memory-mapped tables) and after
    ``append_triples`` (the rebuilt tables), the eager engine and the
    pt layout answer as the torch engine does."""
    rng = np.random.default_rng(7)
    triples = random_triples(rng, 12, 3, 120)
    ds = Dataset.from_triples(triples[:100], threshold=0.25, device="cpu")
    path = ds.save(str(tmp_path / "store"))
    loaded = Dataset.load(path, device="cpu")
    queries = ["SELECT * WHERE { ?a p0 ?b . ?b p1 ?c }",
               "SELECT * WHERE { ?a p1 ?b OPTIONAL { ?b p2 ?c } }",
               "SELECT DISTINCT ?a WHERE { ?a ?q ?b } ORDER BY DESC(?a)"]

    def check(d):
        for q in queries:
            want = d.engine().query(q)
            for eng in (d.engine("eager"), d.engine(layout="pt")):
                assert eng.query(q).same_as(want), q
        assert d.engine(layout="pt").metrics.device_fallbacks == \
            len(queries)

    check(loaded)
    loaded.append_triples(triples[100:])
    check(loaded)
    scratch = Dataset.from_triples(triples, threshold=0.25, device="cpu")
    for q in queries:
        assert loaded.engine("eager").query(q).same_as(
            scratch.engine("eager").query(q)), q
