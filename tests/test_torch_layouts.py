"""The port's storage layouts against the JAX package's ``jit`` engine:
``layout="vp"`` (the paper's vertical-partitioning baseline) and
``"tt"`` (every scan over the triples table) return ``jit``'s rows in
order, with the same final capacities, under the same layout, on the
WatDiv basic suite at scale 0.1 and on the pinned differential corpus;
``"pt"`` (the property table, which runs on the host engine) is served
through the flagged eager fallback, counted per request, and returns
the reference's ``pt`` rows in order."""

import numpy as np
import pytest

from repro.engine import Dataset as RDataset
from repro.rdf.workloads import basic_queries

from repro_torch import Dataset

from test_differential import FIXED_QUERIES, fixed_corpus_triples
from test_torch_engine import assert_same, twin


@pytest.fixture(scope="module")
def watdiv():
    rds = RDataset.watdiv(scale=0.1, seed=0, threshold=0.25)
    return rds, twin(rds)


@pytest.mark.parametrize("layout", ["vp", "tt"])
def test_basic_suite_layout_matches_jit(watdiv, layout):
    rds, ds = watdiv
    ref_eng, eng = rds.engine("jit", layout=layout), \
        ds.engine(layout=layout)
    queries = basic_queries(rds.schema, seed=0)
    for insts in queries.values():
        assert_same(ref_eng, eng, insts[0])
    assert eng.metrics.device_fallbacks == 0
    steps = eng.prepare(queries["S1"][0]).plan.steps
    if layout == "tt":
        assert all(s.uses_tt for s in steps)
    else:
        assert all(s.kind is None and not s.uses_tt for s in steps)


@pytest.mark.parametrize("layout", ["vp", "tt"])
@pytest.mark.parametrize("tau", [0.25, 1.0])
def test_fixed_corpus_layout_matches_jit(layout, tau):
    rds = RDataset.from_triples(fixed_corpus_triples(), threshold=tau)
    ds = twin(rds)
    ref_eng, eng = rds.engine("jit", layout=layout), \
        ds.engine(layout=layout)
    for qtext in FIXED_QUERIES:
        assert_same(ref_eng, eng, qtext)
    assert eng.metrics.device_fallbacks == 0


def _same_pt(ref_eng, eng, qtext):
    r, t = ref_eng.query(qtext), eng.query(qtext)
    assert t.cols == r.cols, qtext
    np.testing.assert_array_equal(t.data, r.data, err_msg=qtext)
    prepared = eng.prepare(qtext)
    assert prepared.fallback and prepared.backend == "eager", qtext


def test_basic_suite_pt_matches_jit_fallback(watdiv):
    """Under ``pt`` both packages serve every template on their host
    engine (the reference's ``jit`` through its flagged fallback too):
    rows in order, and every request counted as a fallback."""
    rds, ds = watdiv
    ref_eng, eng = rds.engine("jit", layout="pt"), ds.engine(layout="pt")
    queries = basic_queries(rds.schema, seed=0)
    for insts in queries.values():
        _same_pt(ref_eng, eng, insts[0])
    assert eng.metrics.device_fallbacks == len(queries) == \
        ref_eng.metrics.device_fallbacks
    batch = [q for insts in queries.values() for q in insts[:2]]
    for r, t in zip(ref_eng.query_batch(batch), eng.query_batch(batch)):
        assert t.cols == r.cols
        np.testing.assert_array_equal(t.data, r.data)
    assert eng.metrics.device_fallbacks == len(queries) + len(batch)


@pytest.mark.parametrize("tau", [0.25, 1.0])
def test_fixed_corpus_pt_matches_jit_fallback(tau):
    rds = RDataset.from_triples(fixed_corpus_triples(), threshold=tau)
    ds = twin(rds)
    ref_eng, eng = rds.engine("jit", layout="pt"), ds.engine(layout="pt")
    for qtext in FIXED_QUERIES:
        _same_pt(ref_eng, eng, qtext)
    assert eng.metrics.device_fallbacks == len(FIXED_QUERIES)


def test_layout_pt_raises_and_unknown_layout_rejected():
    """``pt`` no longer raises: the torch backend prepares it on the
    eager engine, flagged, and every request it serves is counted."""
    rds = RDataset.from_triples(fixed_corpus_triples(), threshold=0.25)
    ds = Dataset.from_triples(fixed_corpus_triples(), threshold=0.25,
                              device="cpu")
    eng = ds.engine(layout="pt")
    q = "SELECT * WHERE { ?a p0 ?b }"
    got, want = eng.query(q), rds.engine("jit", layout="pt").query(q)
    assert got.cols == want.cols and len(got) > 0
    np.testing.assert_array_equal(got.data, want.data)
    assert eng.prepare(q).fallback and eng.prepare(q).backend == "eager"
    assert eng.metrics.device_fallbacks == 1
    with pytest.raises(ValueError):
        ds.engine(layout="parquet")
    assert ds.engine(layout="vp") is ds.engine(layout="vp")
    assert ds.engine(layout="vp") is not ds.engine(layout="tt")
