"""A batch of bindings as one launch sequence, against the JAX package's
vmapped program.

* ``PlanExecutor.run_batch`` of the port against ``repro``'s (its
  ``jax.vmap`` over the template's program) at B ∈ {1, 3, 8}: the same
  bindings of templates over the differential corpus's graphs (BGP,
  FILTER, OPTIONAL, UNION, triples-table scans, a cross join, the empty
  BGP, a statistics-empty branch, modifier spines with ORDER BY,
  DISTINCT and LIMIT / OFFSET) and of its random queries.  Every result
  is equal row for row, and the final capacity vectors are equal.
* A batch in which one binding overflows retries as a whole, and its
  grown caps equal the reference's.
* The twins of ``tests/test_batching.py``'s engine cases, held against
  ``repro``'s ``jit`` engine: padding and occupancy over 5 + 7 + 3
  requests, a missing constant keeping the bucket shape, and a batch of
  32 that probes as many times as one request (the port's form of "one
  program per batch")."""

import re

import numpy as np
import pytest

from repro.engine import Dataset as RDataset
from repro.engine import Engine as REngine
from repro.engine.template import rebind_plan as r_rebind_plan

from repro_torch import Dataset, Engine
from repro_torch.core import jexec
from repro_torch.engine.template import rebind_plan as t_rebind_plan

from test_differential import random_query, random_triples
from test_torch_data import port_catalog

N_ENT = 12

#: templates over the corpus graph ({K}: an entity constant, rebound per
#: binding: a prefixed name with a digit, as template constants are);
#: each names what it drives
TEMPLATES = {
    "bound-scan-hoisted-build":
        "SELECT * WHERE {{ {K} p0 ?v1 . ?v1 p1 ?v2 }}",
    "shared-scan-per-binding-build":
        "SELECT * WHERE {{ ?v0 p0 ?v1 . ?v1 p1 {K} }}",
    "cross-join": "SELECT * WHERE {{ {K} p0 ?v1 . {K} p1 ?v2 }}",
    "object-bound-chain":
        "SELECT * WHERE {{ ?v0 p1 {K} . ?v0 p0 ?v1 . ?v1 p2 ?v2 }}",
    "optional": "SELECT * WHERE {{ {K} p0 ?v1 OPTIONAL {{ ?v1 p1 ?w }} }}",
    "optional-filter-const":
        "SELECT * WHERE {{ ?v0 p0 ?v1 "
        "OPTIONAL {{ ?v1 p1 ?w FILTER(?w != {K}) }} }}",
    "union-order":
        "SELECT * WHERE {{ {{ {K} p0 ?v1 }} UNION {{ {K} p1 ?v1 }} }} "
        "ORDER BY DESC(?v1)",
    "filter-const":
        "SELECT * WHERE {{ ?v0 p0 ?v1 FILTER(?v1 != {K} && ?v0 != ?v1) }}",
    "tt-distinct-slice":
        "SELECT DISTINCT ?v1 WHERE {{ {K} ?q ?v1 }} ORDER BY ?v1 "
        "LIMIT 3 OFFSET 1",
    "empty-bgp-union": "SELECT * WHERE {{ {{ }} UNION {{ {K} p0 ?v1 }} }}",
    "empty-bgp-optional": "SELECT * WHERE {{ OPTIONAL {{ {K} p0 ?v }} }}",
    "statistics-empty-branch":
        "SELECT * WHERE {{ {{ {K} p0 ?v1 }} UNION "
        "{{ ?x p3 ?y . ?y p3 ?v1 }} }}",
    "distinct-order-limit":
        "SELECT DISTINCT ?v0 ?v2 WHERE {{ ?v0 p0 ?v1 . ?v1 p1 ?v2 . "
        "?v1 p2 {K} }} ORDER BY ?v2 DESC(?v0) LIMIT 4",
}


def corpus(seed, tau):
    """A differential-corpus graph (``random_triples``, its entities
    ``eN`` named ``ex:eN`` so that queries can rebind them) with a ``p3``
    whose objects are never subjects, so ``?x p3 ?y . ?y p3 ?z`` is
    statistics-empty; the reference's dataset, the port's twin over the
    same catalog, and the graph's entities."""
    rng = np.random.default_rng(seed)
    triples = [(f"ex:{s}", p, f"ex:{o}")
               for s, p, o in random_triples(rng, N_ENT, 3, 70)]
    triples += [(f"ex:e{i}", "p3", f"lit{i % 3}")
                for i in range(0, N_ENT, 2)]
    pool = sorted({t for s, _, o in triples for t in (s, o)
                   if t.startswith("ex:")})
    rds = RDataset.from_triples(triples, threshold=tau)
    return rng, rds, Dataset(catalog=port_catalog(rds.catalog),
                             device="cpu"), pool


def batch_args(prepared, bindings, rebind):
    ex = prepared.executor
    bounds = [ex.bounds_from_plan(rebind(prepared.plan, b.mapping))
              for b in bindings]
    fconsts = [ex.fconsts_from_mapping(b.mapping) for b in bindings]
    return bounds, fconsts


def run_both(reng, teng, texts):
    """The bindings of ``texts`` (instances of one template) through both
    executors' ``run_batch``; the results must be equal row for row and
    the caps equal.  Returns the port's prepared query, or None when the
    template has no executor (statistics-empty) or a constant is
    missing from the dictionary."""
    rp, tp = reng.prepare(texts[0]), teng.prepare(texts[0])
    assert hasattr(rp, "executor") == hasattr(tp, "executor"), texts[0]
    if not hasattr(tp, "executor"):
        return None
    rb = [rp.template.binding_for(q) for q in texts]
    tb = [tp.template.binding_for(q) for q in texts]
    assert [b.mapping for b in rb] == [b.mapping for b in tb]
    assert [b.missing for b in rb] == [b.missing for b in tb]
    if any(b.missing for b in tb):
        return None
    want = rp.executor.run_batch(*batch_args(rp, rb, r_rebind_plan))
    got = tp.executor.run_batch(*batch_args(tp, tb, t_rebind_plan))
    assert len(got) == len(want) == len(texts)
    for q, (gd, gc), (wd, wc) in zip(texts, got, want):
        assert gc == wc, q
        assert gd.dtype == np.int32
        np.testing.assert_array_equal(gd, np.asarray(wd), err_msg=q)
    assert tp.executor.caps == list(rp.executor.caps), texts[0]
    return tp


def entities(rng, pool, n):
    return [pool[k] for k in rng.integers(0, len(pool), n)]


_ENTITY = re.compile(r"\be\d+\b")


def variants(rng, pool, qtext, n):
    """``n`` instances of a random query's template: each entity constant
    redrawn per instance from the graph's (predicates are plan identity
    and stay)."""
    return [_ENTITY.sub(lambda _: entities(rng, pool, 1)[0], qtext)
            for _ in range(n)]


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("seed,tau", [(5, 0.25), (11, 1.0)])
def test_run_batch_matches_reference_templates(seed, tau, batch):
    rng, rds, ds, pool = corpus(seed, tau)
    reng, teng = rds.engine("jit"), ds.engine()
    ran = 0
    for name, tmpl in TEMPLATES.items():
        texts = [tmpl.format(K=k) for k in entities(rng, pool, batch)]
        ran += run_both(reng, teng, texts) is not None
    # every template but the statistics-empty one has an executor
    assert ran >= len(TEMPLATES) - 1
    assert teng.metrics.device_fallbacks == 0


@pytest.mark.parametrize("batch", [3, 8])
@pytest.mark.parametrize("seed", [3, 29, 104])
def test_run_batch_matches_reference_random(seed, batch):
    """The differential corpus's random queries, their constants redrawn
    per binding."""
    rng, rds, ds, pool = corpus(seed, (0.25, 1.0)[seed % 2])
    reng, teng = rds.engine("jit"), ds.engine()
    for _ in range(4):
        qtext = random_query(rng, N_ENT, 3)
        run_both(reng, teng, variants(rng, pool, qtext, batch))


def overflow_graph():
    """A hub reaches a 12-node p1 clique, so a 4-step chain from it
    yields 12^3 rows, past its statistics-seeded caps; a leaf reaches
    nothing."""
    clique = [f"n{i}" for i in range(12)]
    triples = [(a, "p1", b) for a in clique for b in clique]
    triples += [("ex:hub1", "p0", "n0"), ("ex:leaf1", "p0", "x"),
                ("x", "p2", "y")]
    rds = RDataset.from_triples(triples, threshold=1.0)
    return rds, Dataset(catalog=port_catalog(rds.catalog), device="cpu")


CHAIN = "SELECT * WHERE {{ {K} p0 ?v1 . ?v1 p1 ?v2 . ?v2 p1 ?v3 . " \
        "?v3 p1 ?v4 }}"


def test_one_binding_overflowing_retries_the_batch():
    rds, ds = overflow_graph()
    texts = [CHAIN.format(K=k) for k in ("ex:leaf1", "ex:hub1", "ex:leaf1")]
    # the leaves alone keep the seeded caps
    tp = ds.engine().prepare(texts[0])
    seeded = list(tp.executor.caps)
    assert run_both(REngine(rds, backend="jit"), Engine(ds, device="cpu"),
                    [texts[0], texts[2]]).executor.caps == seeded
    # with the hub the whole batch retries, and the caps grow as the
    # reference's do
    tp = run_both(REngine(rds, backend="jit"), Engine(ds, device="cpu"),
                  texts)
    assert tp.executor.caps != seeded
    res = tp.executor.run_batch(*batch_args(
        tp, [tp.template.binding_for(q) for q in texts], t_rebind_plan))
    assert [len(d) for d, _ in res] == [0, 12**3, 0]


# ---------------------------------------------------------------------------
# tests/test_batching.py's engine cases, against the reference's jit engine
# ---------------------------------------------------------------------------

def _instances(n, start=1):
    return [f"SELECT * WHERE {{ wsdbm:User{u} wsdbm:follows ?v . "
            f"?v sorg:email ?e }}" for u in range(start, start + n)]


MISSING = ("SELECT * WHERE { wsdbm:User999999 wsdbm:follows ?v . "
           "?v sorg:email ?e }")


@pytest.fixture(scope="module")
def pair(watdiv_small):
    cat, d, sch = watdiv_small
    rds = RDataset(catalog=cat, dictionary=d, schema=sch)
    return rds, Dataset(catalog=port_catalog(cat), device="cpu")


def same_batch(rres, tres):
    for r, t in zip(rres, tres):
        assert t.cols == r.cols
        np.testing.assert_array_equal(t.data, r.data)


def test_padding_and_occupancy_match_reference(pair):
    """The twin of ``test_one_compile_per_template_and_bucket_shape``:
    5, 7 and 3 requests fill buckets of 8, 8 and 4."""
    rds, ds = pair
    ref, eng = REngine(rds, backend="jit"), Engine(ds, device="cpu")
    for qs in (_instances(5), _instances(7, start=2),
               _instances(3, start=11)):
        same_batch(ref.query_batch(qs), eng.query_batch(qs))
    m, rm = eng.metrics.summary(), ref.metrics.summary()
    assert m["batches"] == rm["batches"] == 3
    assert m["batched_requests"] == rm["batched_requests"] == 15
    assert m["batch_occupancy"] == rm["batch_occupancy"] == \
        pytest.approx(15 / 20)
    assert m["padding_waste"] == rm["padding_waste"] == pytest.approx(5 / 20)
    prepared = eng.prepare(_instances(1)[0])
    assert prepared.executor.caps == list(
        ref.prepare(_instances(1)[0]).executor.caps)
    # the tuner saw every launch: its books per shape are the
    # reference's (its times are the host clock's, so they differ)
    got, want = eng.tuner.report()["buckets"], ref.tuner.report()["buckets"]
    assert sorted(got) == sorted(want)
    for shape in got:
        assert got[shape]["padding_waste"] == want[shape]["padding_waste"]
        assert got[shape]["launches"] == want[shape]["launches"]


def test_missing_constants_do_not_shrink_batch_shape(pair, monkeypatch):
    """A missing-constant request inside a bucket is answered on the
    host; the device batch is padded back to the bucket shape."""
    rds, ds = pair
    ref, eng = REngine(rds, backend="jit"), Engine(ds, device="cpu")
    same_batch(ref.query_batch(_instances(4)), eng.query_batch(_instances(4)))
    prepared = eng.prepare(_instances(1)[0])
    shapes = []
    inner = prepared.executor.run_batch

    def counted(bounds, *a, **k):
        shapes.append(len(bounds))
        return inner(bounds, *a, **k)

    monkeypatch.setattr(prepared.executor, "run_batch", counted)
    with_missing = _instances(3) + [MISSING]
    res = eng.query_batch(with_missing)
    same_batch(ref.query_batch(with_missing), res)
    assert shapes == [4] and len(res[-1]) == 0
    assert eng.metrics.summary()["padding_waste"] == \
        ref.metrics.summary()["padding_waste"]


def test_batch32_probes_as_often_as_one_request(pair, monkeypatch):
    """The twin of ``test_batch32_single_launch_matches_sequential_eager``:
    a 32-request same-template batch is one launch sequence, so it calls
    the join probe as many times as one request does, and its results
    equal the reference's."""
    rds, ds = pair
    users = [u for u in range(0, 40) if u not in (25, 32)][:32]
    queries = [f"SELECT * WHERE {{ wsdbm:User{u} wsdbm:follows ?v . "
               f"?v sorg:email ?e }}" for u in users]
    eng = Engine(ds, device="cpu")
    calls = []
    inner = jexec.ops.join_probe

    def counted(probe, build):
        calls.append(tuple(probe.shape))
        return inner(probe, build)

    monkeypatch.setattr(jexec.ops, "join_probe", counted)
    eng.query(queries[0])
    one = len(calls)
    calls.clear()
    batched = eng.query_batch(queries)
    assert one >= 1 and len(calls) == one
    assert all(shape[0] == 32 for shape in calls)
    ref = REngine(rds, backend="jit")
    same_batch(ref.query_batch(queries), batched)
    m = eng.metrics.summary()
    assert m["batches"] == 1 and m["batch_occupancy"] == 1.0
