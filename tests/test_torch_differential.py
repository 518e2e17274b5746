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
"""

import numpy as np
import pytest

from repro.engine import Dataset as RDataset
from repro.engine import RuntimeConfig as RRuntimeConfig

from repro_torch import Dataset

from test_differential import (
    assert_matches_oracle, assert_multiset_equal, assert_rows_equal,
    random_query, random_triples,
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
