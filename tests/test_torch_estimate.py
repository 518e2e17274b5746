"""The port's estimate planner and layouts against the JAX package.

* ``estimate_order``, ``order_steps``, ``scan_estimate`` and
  ``actual_cardinalities`` give the reference's numbers and orders on
  one catalog (the reference's, carried across with
  ``catalog_from_arrays``), over the WatDiv basic suite and the pinned
  differential corpus;
* ``tests/test_estimate.py``'s properties hold for the port;
* ``planner="estimate"`` over ``FIXED_QUERIES`` and the WatDiv basic
  suite returns the ``jit`` engine's rows, in order, under the same
  planner, with the same final capacities;
* ``explain()`` gives the reference's plan, planner and per-step
  cardinality lines.

The layouts are held against ``jit`` in ``test_torch_layouts.py``.
"""

import numpy as np
import pytest

from repro.core import estimate as rest
from repro.core.compiler import compile_bgp as rcompile_bgp
from repro.core.modifiers import peel_spine as rpeel_spine
from repro.core.sparql import parse_sparql as rparse
from repro.engine import Dataset as RDataset
from repro.engine import RuntimeConfig as RRuntimeConfig
from repro.rdf.workloads import basic_queries

from repro_torch import Dataset, RuntimeConfig
from repro_torch.core import estimate as est
from repro_torch.core.algebra import tp_vars
from repro_torch.core.compiler import compile_bgp
from repro_torch.core.modifiers import peel_spine
from repro_torch.core.sparql import parse_sparql

from test_differential import FIXED_QUERIES, fixed_corpus_triples
from test_torch_engine import assert_same, twin

TAUS = (0.25, 1.0)
R_ESTIMATE = RRuntimeConfig(planner="estimate")


@pytest.fixture(scope="module")
def watdiv():
    rds = RDataset.watdiv(scale=0.1, seed=0, threshold=0.25)
    return rds, twin(rds)


def _graph(seed, n_ent=24, n_preds=4, n_triples=140):
    rng = np.random.default_rng(seed)
    return [(f"e{rng.integers(0, n_ent)}", f"p{rng.integers(0, n_preds)}",
             f"e{rng.integers(0, n_ent)}") for _ in range(n_triples)]


def _bgp_plan(ds, body, planner="estimate", layout="extvp"):
    query = parse_sparql(f"SELECT * WHERE {{ {body} }}", ds.dictionary)
    core, _ = peel_spine(query)
    return compile_bgp(core, ds.catalog, layout, planner)


def _final_estimate(ds, body):
    rows = est.estimate_order(_bgp_plan(ds, body).steps, ds.catalog)
    assert rows is not None
    return rows[-1].rows


def _cpu(triples, tau):
    return Dataset.from_triples(triples, threshold=tau, device="cpu")


# ---------------------------------------------------------------------------
# The module against the reference's, on one catalog
# ---------------------------------------------------------------------------

def _bgp_queries(schema):
    """First instances of the basic templates whose core is a BGP, then
    the pinned corpus's BGP queries (their constants are concrete here)."""
    out = [q[0] for q in basic_queries(schema, seed=0).values()]
    return out + [q for q in FIXED_QUERIES if "UNION" not in q
                  and "OPTIONAL" not in q]


def _step_key(s):
    return (str(s.tp), s.kind, s.p2, s.sf, s.size, s.uses_tt)


@pytest.mark.parametrize("planner", ["greedy", "estimate"])
@pytest.mark.parametrize("layout", ["extvp", "vp", "tt"])
def test_estimates_and_orders_equal_reference(watdiv, planner, layout):
    rds, ds = watdiv
    checked = 0
    for qtext in _bgp_queries(rds.schema):
        rcore, _ = rpeel_spine(rparse(qtext, rds.dictionary))
        core, _ = peel_spine(parse_sparql(qtext, ds.dictionary))
        if type(core).__name__ != "BGP":
            continue
        want = rcompile_bgp(rcore, rds.catalog, layout, planner)
        got = compile_bgp(core, ds.catalog, layout, planner)
        assert got.planner == want.planner and got.empty == want.empty
        assert [_step_key(s) for s in got.steps] == \
            [_step_key(s) for s in want.steps], qtext
        if got.empty:
            continue
        assert [_step_key(s) for s in
                est.order_steps(got.steps, ds.catalog)] == \
            [_step_key(s) for s in
             rest.order_steps(want.steps, rds.catalog)], qtext
        for a, b in zip(est.estimate_order(got.steps, ds.catalog),
                        rest.estimate_order(want.steps, rds.catalog)):
            assert (a.scan_rows, a.rows) == (b.scan_rows, b.rows), qtext
        for a, b in zip(got.steps, want.steps):
            assert est.scan_estimate(a, ds.catalog) == \
                rest.scan_estimate(b, rds.catalog)
        assert est.actual_cardinalities(got.steps, ds.catalog) == \
            rest.actual_cardinalities(want.steps, rds.catalog), qtext
        checked += 1
    assert checked >= 15


def test_actual_cardinalities_read_lazy_stores(tmp_path):
    """A store loaded lazily (memory-mapped tables) gives the same
    actual column as the in-memory catalog it was saved from."""
    ds = _cpu(_graph(3), 0.25)
    ds.save(str(tmp_path / "s"))
    lazy = Dataset.load(str(tmp_path / "s"), device="cpu")
    for body in ("?a p0 ?b . ?b p1 ?c", "e1 p0 ?b . ?b ?q ?c",
                 "?a p2 ?b . ?a p3 ?c . ?c p0 ?d"):
        plan = _bgp_plan(ds, body)
        assert est.actual_cardinalities(plan.steps, lazy.catalog) == \
            est.actual_cardinalities(plan.steps, ds.catalog)


# ---------------------------------------------------------------------------
# tests/test_estimate.py's properties, on the port
# ---------------------------------------------------------------------------

def test_single_pattern_estimate_is_exact():
    for seed in (0, 1, 2):
        ds = _cpu(_graph(seed), 0.25)
        eng = ds.engine(planner="estimate")
        for body in ("?s p0 ?o", "?s p2 ?o", "?s ?p ?o"):
            got = len(eng.query(f"SELECT * WHERE {{ {body} }}"))
            assert _final_estimate(ds, body) == pytest.approx(got), \
                (seed, body)


def test_estimate_monotone_under_functional_correlation():
    for seed in (5, 6):
        rng = np.random.default_rng(seed)
        triples = []
        for e in range(30):
            for _ in range(int(rng.integers(1, 4))):
                triples.append((f"e{e}", "p0", f"e{rng.integers(0, 30)}"))
            for p in ("p1", "p2", "p3"):
                if rng.random() < 0.8:
                    triples.append((f"e{e}", p, f"v{rng.integers(0, 6)}"))
        ds = _cpu(triples, 1.0)
        star = ["?x p0 ?y0", "?x p1 ?y1", "?x p2 ?y2", "?x p3 ?y3"]
        prev = float("inf")
        for k in range(1, len(star) + 1):
            cur = _final_estimate(ds, " . ".join(star[:k]))
            assert cur <= prev + 1e-9, (seed, k, cur, prev)
            prev = cur


def test_short_circuits_survive_estimate_planner():
    triples = [(f"e{i}", "p0", f"v{i}") for i in range(8)] + \
              [(f"w{i}", "p1", f"w{i + 1}") for i in range(8)]
    for tau in TAUS:
        ds = _cpu(triples, tau)
        for planner in ("greedy", "estimate"):
            assert _bgp_plan(ds, "?a p0 ?b . ?b p1 ?c", planner).empty
            assert _bgp_plan(ds, "?a p0 ?b . ?b p1 e9999", planner).empty
            eng = ds.engine(runtime=RuntimeConfig(planner=planner))
            res = eng.query("SELECT * WHERE { ?a p0 ?b . ?b p1 ?c }")
            assert len(res) == 0
            assert eng.metrics.short_circuits >= 1, (tau, planner)


def test_bound_term_estimate_is_skew_aware():
    triples = [(f"e{i}", "p0", "big" if i < 60 else f"t{i}")
               for i in range(64)]
    triples += [(f"e{i}", "p1", f"g{i % 3}") for i in range(60)]
    ds = _cpu(triples, 1.0)
    skewed = _bgp_plan(ds, "?s p0 big")
    uniform = _bgp_plan(ds, "?s p1 g0")
    assert est.scan_estimate(skewed.steps[0], ds.catalog)[0] == \
        pytest.approx((60 ** 2 + 4) / 64)
    assert est.scan_estimate(uniform.steps[0], ds.catalog)[0] == \
        pytest.approx(60 / 3)
    ds.catalog.m2_s = ds.catalog.m2_o = None
    assert est.scan_estimate(skewed.steps[0], ds.catalog)[0] == \
        pytest.approx(64 / 5)


def test_disconnected_bgp_estimates_cross_product():
    for seed in (7, 8):
        ds = _cpu(_graph(seed), 1.0)
        eng = ds.engine(planner="estimate")
        body = "?a p0 ?b . ?c p1 ?d"
        got = len(eng.query(f"SELECT * WHERE {{ {body} }}"))
        n0 = ds.catalog.vp_size(int(ds.dictionary.term_to_id["p0"]))
        n1 = ds.catalog.vp_size(int(ds.dictionary.term_to_id["p1"]))
        assert got == n0 * n1
        assert _final_estimate(ds, body) == pytest.approx(got), seed


def test_enumerator_permutes_and_stays_connected():
    ds = _cpu(_graph(11), 0.25)
    for body in ("?a p0 ?b . ?b p1 ?c . ?c p2 ?d",
                 "?a p0 ?b . ?a p1 ?c . ?b p2 ?d . ?c p3 ?e",
                 "e1 p0 ?b . ?b p1 ?c . ?c p2 ?d . ?d p3 ?e . ?e p0 ?f"):
        greedy = _bgp_plan(ds, body, planner="greedy")
        enum = _bgp_plan(ds, body, planner="estimate")
        assert enum.planner == "estimate"
        assert sorted(map(_step_key, greedy.steps)) == \
            sorted(map(_step_key, enum.steps)), body
        bound = set()
        for i, step in enumerate(enum.steps):
            if i:
                assert bound & set(tp_vars(step.tp)), (body, i)
            bound |= set(tp_vars(step.tp))


def test_estimate_falls_back_without_distinct_stats():
    ds = _cpu(_graph(13), 0.25)
    q = "SELECT * WHERE { ?a p0 ?b . ?b p1 ?c }"
    want = ds.engine().query(q)
    ds.catalog.distinct_s = ds.catalog.distinct_o = None
    assert not est.supports(ds.catalog)
    plan = _bgp_plan(ds, "?a p0 ?b . ?b p1 ?c")
    assert not plan.empty and plan.planner == "greedy"
    eng = ds.engine(planner="estimate")
    np.testing.assert_array_equal(eng.query(q).data, want.data)
    assert "planner: greedy (requested estimate)" in eng.explain(q)


def test_plan_cache_keys_on_planner_knob():
    ds = _cpu(_graph(17), 0.25)
    q = "SELECT * WHERE { ?a p0 ?b . ?b p1 ?c }"
    cfg = RuntimeConfig(planner="greedy")
    eng = ds.engine(runtime=cfg)
    p_greedy = eng.prepare(q)
    assert p_greedy.plan.planner == "greedy"
    cfg.planner = "estimate"
    p_est = eng.prepare(q)
    assert p_est is not p_greedy and p_est.plan.planner == "estimate"
    assert len(eng.cache) == 2
    cfg.planner = "greedy"
    assert eng.prepare(q) is p_greedy
    assert eng.runtime_report()["planner"] == "greedy"
    eng_g = ds.engine(runtime=RuntimeConfig(planner="greedy"))
    eng_e = ds.engine(runtime=RuntimeConfig(planner="estimate"))
    assert eng_g is not eng_e
    rg, re_ = eng_g.query(q), eng_e.query(q)
    assert eng_e.prepare(q).plan.planner == "estimate"
    assert eng_e.runtime_report()["planner"] == "estimate"
    cols = sorted(rg.cols)
    assert sorted(map(tuple, rg.data[:, [rg.cols.index(c) for c in cols]]
                      .tolist())) == \
        sorted(map(tuple, re_.data[:, [re_.cols.index(c) for c in cols]]
                   .tolist()))
    # an explicit planner= beats the config's
    assert ds.engine(planner="greedy",
                     runtime=RuntimeConfig(planner="estimate")).planner \
        == "greedy"


def test_runtime_config_rejects_unknown_planner():
    with pytest.raises(ValueError):
        RuntimeConfig(planner="cost-based-v2")
    ds = _cpu(_graph(19), 1.0)
    with pytest.raises(ValueError):
        _bgp_plan(ds, "?a p0 ?b", planner="nope")
    with pytest.raises(ValueError):
        ds.engine(planner="nope")


# ---------------------------------------------------------------------------
# End to end against jit, under the same planner and layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau", TAUS)
def test_fixed_corpus_estimate_matches_jit(tau):
    rds = RDataset.from_triples(fixed_corpus_triples(), threshold=tau)
    ds = twin(rds)
    ref_eng = rds.engine("jit", runtime=R_ESTIMATE)
    eng = ds.engine(planner="estimate")
    for qtext in FIXED_QUERIES:
        assert_same(ref_eng, eng, qtext)
        assert eng.prepare(qtext).plan.planner == \
            ref_eng.prepare(qtext).plan.planner
    assert eng.metrics.device_fallbacks == 0


def test_basic_suite_estimate_matches_jit(watdiv):
    rds, ds = watdiv
    ref_eng = rds.engine("jit", runtime=R_ESTIMATE)
    eng = ds.engine(planner="estimate")
    greedy = ds.engine()
    planners = set()
    for name, insts in basic_queries(rds.schema, seed=0).items():
        got = assert_same(ref_eng, eng, insts[0])
        planners.add(eng.prepare(insts[0]).plan.planner)
        # the enumerated order is bag-equal to Algorithm 4's
        want = greedy.query(insts[0])
        cols = sorted(got.cols)
        assert sorted(map(tuple, got.data[:, [got.cols.index(c)
                                               for c in cols]].tolist())) \
            == sorted(map(tuple, want.data[:, [want.cols.index(c)
                                                for c in cols]].tolist())), \
            name
    assert "estimate" in planners
    assert eng.metrics.device_fallbacks == 0


def _explain_lines(text):
    """explain() less its backend line and the reference's verifier
    line (the port has no plan verifier yet)."""
    return [ln for ln in text.splitlines()
            if not ln.startswith(("backend:", "verifier", "verify"))]


@pytest.mark.parametrize("planner", ["greedy", "estimate"])
def test_explain_matches_reference(watdiv, planner):
    rds, ds = watdiv
    ref_eng = rds.engine("jit", runtime=RRuntimeConfig(planner=planner,
                                                       verify_plans=False))
    eng = ds.engine(planner=planner)
    queries = [q[0] for q in basic_queries(rds.schema, seed=0).values()]
    queries += ["SELECT * WHERE { wsdbm:User999999 wsdbm:follows ?v . "
                "?v sorg:email ?e }",
                "SELECT * WHERE { ?p sorg:price ?x . ?x wsdbm:follows ?y }"]
    for qtext in queries:
        got, want = eng.explain(qtext), ref_eng.explain(qtext)
        assert _explain_lines(got) == _explain_lines(want)[:len(
            _explain_lines(got))], qtext
        assert got.splitlines()[-1] == "backend: torch (forced)"
    star = eng.explain(basic_queries(rds.schema, seed=0)["S1"][0])
    assert "est=" in star and "actual=" in star
