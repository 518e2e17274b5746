"""The port's twin of ``tests/test_differential.py``'s random corpus.

For each seed of a fixed list: a random graph (τ alternating 0.25 and
1.0) and random BGP / FILTER / OPTIONAL / UNION / unbound-predicate
queries under random modifier spines, drawn with the reference's own
``random_triples`` / ``random_query``.  The port serves each query over
its own ``"torch"`` build (on the CPU) under both planners, and

* its catalog equals the reference's numpy build (SF, sizes, tables);
* each result matches the brute-force oracle (``core/reference.py``) by
  the reference's rules: multisets, and for LIMIT/OFFSET the count and
  the pre-slice bag;
* each result equals the reference's ``jit`` engine row for row under
  the same planner (not ``eager``'s: under the estimate planner the
  reference's eager engine plans the BGPs inside OPTIONAL / UNION cores
  greedily, ``src/repro/core/executor.py:347``, so where ORDER BY leaves
  ties its rows may come in another order than ``jit``'s);
* **order invariance**: the estimate planner's rows are bag-equal to
  the greedy planner's;
* ``query_batch`` of the graph's queries equals the single runs;
* nothing falls back (``device_fallbacks == 0``).

The template-instance corpus: the same random graphs and queries with
entities named ``ex:eN`` and predicates ``ex:pa``-``ex:pc``, so that
entity constants are template constants and instances of one template
batch, plus shapes with a constant under OPTIONAL, in a UNION branch and
in a FILTER, and absent predicates.  Each instance draws its constants
anew, some absent from the dictionary.  The torch and eager engines
(single and batched) and the distributed engine (two gloo ranks) must
equal ``repro/core/reference.py`` on every instance: row for row in the
ORDER BY keys, as multisets elsewhere.  Here the port departs from the
reference's ``jit`` and ``eager`` engines, which empty the whole answer
for any missing constant (``tests/test_torch_engine.py::
test_reference_jit_empties_answers_the_oracle_keeps``).
"""

import re

import numpy as np
import pytest

from repro.core.reference import execute_reference
from repro.core.sparql import parse_sparql as r_parse_sparql
from repro.engine import Dataset as RDataset
from repro.engine import RuntimeConfig as RRuntimeConfig
from repro.rdf.dictionary import UNBOUND

from repro_torch import Dataset, Result
from repro_torch.core.executor import Bindings

from _torch_dist_jobs import run_group
from test_differential import (
    _SLICE_RE, assert_matches_oracle, assert_multiset_equal,
    assert_rows_equal, random_query, random_triples,
)

SEEDS = (3, 17, 29, 41, 58, 73, 96, 104, 131, 152, 187, 203)
PLANNERS = ("greedy", "estimate")
QUERIES_PER_GRAPH = 3


@pytest.mark.parametrize("seed", SEEDS)
def test_port_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n_ent = int(rng.integers(4, 16))
    n_preds = int(rng.integers(1, 4))
    triples = random_triples(rng, n_ent, n_preds, int(rng.integers(4, 50)))
    tau = (0.25, 1.0)[SEEDS.index(seed) % 2]

    rds = RDataset.from_triples(triples, threshold=tau)
    ds = Dataset.from_triples(triples, threshold=tau, device="cpu")
    rcat, cat = rds.catalog, ds.catalog
    assert cat.extvp.sf == rcat.extvp.sf
    assert cat.extvp.sizes == rcat.extvp.sizes
    assert sorted(cat.extvp.tables) == sorted(rcat.extvp.tables)
    for k, t in rcat.extvp.tables.items():
        np.testing.assert_array_equal(cat.extvp.tables[k].rows, t.rows)

    d, tt = rds.dictionary, rcat.tt
    engines = {p: ds.engine(planner=p) for p in PLANNERS}
    refs = {p: rds.engine("jit", runtime=RRuntimeConfig(planner=p))
            for p in PLANNERS}
    queries = [random_query(rng, n_ent, n_preds)
               for _ in range(QUERIES_PER_GRAPH)]
    for qtext in queries:
        got = {}
        for p in PLANNERS:
            got[p] = engines[p].query(qtext)
            ctx = (seed, tau, p, qtext)
            assert got[p].data.dtype == np.int32
            assert_matches_oracle(got[p], qtext, d, tt, ctx)
            assert_rows_equal(got[p], refs[p].query(qtext), ctx)
        assert_multiset_equal(got["estimate"], got["greedy"], qtext,
                              (seed, tau, "est-vs-greedy"))
    for p in PLANNERS:
        batched = engines[p].query_batch(queries)
        for qtext, res in zip(queries, batched):
            assert_rows_equal(res, engines[p].query(qtext),
                              (seed, tau, p, "batch", qtext))
        assert engines[p].metrics.device_fallbacks == 0, (seed, p)


# ---------------------------------------------------------------------------
# The template-instance corpus: constants drawn per instance, some absent
# from the dictionary, served single, batched and distributed
# ---------------------------------------------------------------------------

#: predicate names of the corpus: ``ex:pa``-``ex:pc`` carry no digit, so
#: they stay in the template text (schema terms); entities ``ex:eN`` are
#: template constants, rebound per instance
PREDS = "abc"
_ENT_RE = re.compile(r"(?<![\w?:])e(\d+)\b")
_PRED_RE = re.compile(r"(?<![\w?:])p(\d)\b")
SLOT = "§"

#: shapes that put a constant (``§``) where a missing one must not empty
#: the answer — under OPTIONAL, in one UNION branch, in a FILTER (an
#: entity and a literal) — beside required ones, and predicates absent
#: from the dictionary: ``ex:pz`` (a schema term, no slot) and ``ex:p7``
#: (a digit: a template constant in predicate position, so the template
#: is served concrete)
MISSING_SHAPES = [
    "SELECT * WHERE { ?v0 ex:pa ?v1 OPTIONAL { ?v1 ex:pb § } }",
    "SELECT * WHERE { { ?v0 ex:pa ?v1 } UNION { ?v0 ex:pb § } }",
    "SELECT * WHERE { ?v0 ex:pa ?v1 FILTER(?v1 != §) }",
    'SELECT * WHERE { ?v0 ex:pa ?v1 FILTER(?v1 != "lit") }',
    "SELECT * WHERE { ?v0 ex:pa ?v1 FILTER(?v1 != § && ?v0 != §) } "
    "ORDER BY DESC(?v1)",
    "SELECT * WHERE { § ex:pa ?v1 OPTIONAL { ?v1 ex:pb ?w } }",
    "SELECT * WHERE { ?v0 ex:pa ?v1 . ?v1 ex:pb § } ORDER BY ?v0",
    "SELECT * WHERE { ?v0 ex:pa ?v1 OPTIONAL { ?v1 ex:pz ?w } }",
    "SELECT * WHERE { ?v0 ex:pa ?v1 OPTIONAL { ?v1 ex:p7 ?w } }",
    "SELECT * WHERE { { ?v0 ex:pa ?v1 } UNION { ?v0 ex:pz § } } "
    "ORDER BY DESC(?v1)",
    "SELECT DISTINCT ?v1 WHERE { ?v0 ex:pa ?v1 "
    "OPTIONAL { ?v1 ex:pa ?w FILTER(?w != §) } } ORDER BY ?v1",
]
CORPUS_SEEDS = (5, 11, 23, 47)
INSTANCES = 4


def ex_triples(rng, n_ent, n_preds, n):
    return [(f"ex:{s}", f"ex:p{PREDS[int(p[1:])]}", f"ex:{o}")
            for s, p, o in random_triples(rng, n_ent, n_preds, n)]


def as_template(qtext):
    """A ``random_query`` text with its predicates renamed and every
    entity constant lifted into a slot."""
    qtext = _PRED_RE.sub(lambda m: f"ex:p{PREDS[int(m.group(1))]}", qtext)
    return _ENT_RE.sub(SLOT, qtext)


def instantiate(template, rng, n_ent):
    """One instance: each slot an entity drawn from ``[0, n_ent + 3)``,
    so some are absent from the graph (and from the dictionary)."""
    out = template
    while SLOT in out:
        out = out.replace(SLOT, f"ex:e{rng.integers(0, n_ent + 3)}", 1)
    return out


def corpus_instances(seed):
    """The graph of ``seed`` and its instances: every template's
    instances next to each other (so that they batch)."""
    rng = np.random.default_rng(seed)
    n_ent = int(rng.integers(4, 10))
    triples = ex_triples(rng, n_ent, 3, int(rng.integers(20, 50)))
    templates = [as_template(random_query(rng, n_ent, 3))
                 for _ in range(4)] + MISSING_SHAPES
    return triples, [instantiate(t, rng, n_ent) for t in templates
                     for _ in range(INSTANCES)]


def assert_matches_oracle_rows(res, qtext, rds, ctx):
    """``res`` against ``repro/core/reference.py``: as a multiset (by the
    count and the pre-slice bag under LIMIT/OFFSET), and, under ORDER BY,
    row for row in the ORDER BY keys."""
    d, tt = rds.dictionary, rds.catalog.tt
    assert_matches_oracle(res, qtext, d, tt, ctx)
    keys = _order_keys(qtext)
    if not keys or _SLICE_RE.search(qtext):
        return
    want = execute_reference(r_parse_sparql(qtext, d), tt, d.values)
    got = [tuple(int(row[res.cols.index(k)]) for k in keys)
           for row in np.asarray(res.data)]
    assert got == [tuple(m.get(k, UNBOUND) for k in keys) for m in want], \
        (ctx, qtext)


def _order_keys(qtext):
    m = re.search(r"ORDER BY (.*?)(LIMIT|OFFSET|$)", qtext)
    return re.findall(r"\?\w+", m.group(1)) if m else []


def _has_missing(rds, qtext):
    return any(rds.dictionary.id_of(t) is None
               for t in re.findall(r"ex:e\d+", qtext))


@pytest.mark.parametrize("seed", CORPUS_SEEDS)
def test_template_instances_match_oracle(seed):
    """Single device: the torch engine, single and as batches, and the
    eager engine, every instance held against the oracle."""
    triples, queries = corpus_instances(seed)
    rds = RDataset.from_triples(triples, threshold=1.0)
    ds = Dataset.from_triples(triples, threshold=1.0, device="cpu")
    assert list(ds.dictionary.id_to_term) == list(rds.dictionary.id_to_term)
    assert any(_has_missing(rds, q) for q in queries)
    for backend in ("torch", "eager"):
        eng = ds.engine(backend)
        batched = eng.query_batch(queries)
        for q, b in zip(queries, batched):
            one = eng.query(q)
            assert_matches_oracle_rows(one, q, rds, (seed, backend))
            assert_rows_equal(b, one, (seed, backend, "batch", q))
        assert eng.metrics.device_fallbacks == 0, (seed, backend)
    m = ds.engine().metrics.summary()
    assert m["batches"] < len(queries)      # instances shared launches


@pytest.mark.parametrize("seed", CORPUS_SEEDS[:2])
def test_template_instances_match_oracle_distributed(tmp_path, seed):
    """Two gloo ranks: every instance single and in one batch, on every
    rank, held against the oracle."""
    triples, queries = corpus_instances(seed)
    rds = RDataset.from_triples(triples)
    ranks = run_group("queries", 2, tmp_path, triples=triples,
                      queries=queries)
    for rank in ranks:
        assert rank["terms"] == list(rds.dictionary.id_to_term)
        assert rank["fallbacks"] == 0
        for q, one, batched in zip(queries, rank["single"],
                                   rank["batched"]):
            for got in (one, batched):
                assert_matches_oracle_rows(
                    Result(Bindings(got["cols"], got["data"]),
                           rds.dictionary), q, rds, (seed, "dist"))
