"""The port's plan verifier against the JAX package's, report for report.

Every verifier case of ``tests/test_analysis.py`` is built twice from the
same triples — once on the reference's compiler and executor, once on
the port's — and gets the same corruption; the port's
:class:`~repro_torch.analysis.VerificationReport` must equal the
reference's diagnostic for diagnostic (rule, severity, message,
location) and in the checks it ran.  Also:

* over the pinned differential corpus and the WatDiv basic suite, every
  planner and every prepared form — the port's ``eager`` and ``torch``
  in process, its ``distributed`` over two gloo ranks — reports what the
  reference's ``eager``, ``jit`` and ``distributed`` report;
* ``Engine(verify_plans=True)`` raises before a rejected plan is cached
  or launched, through ``query`` and ``query_batch``; ``explain()``'s
  verdict line equals the reference's, whatever the knob says;
* a lazily loaded store keeps ``n_loaded`` unchanged under
  verification, and ``PLACEHOLDER_BASE`` is the template band's.
"""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import repro.analysis as R_AN
from repro.core.compiler import Plan as RPlan
from repro.core.compiler import compile_bgp as r_compile_bgp
from repro.core.compiler import compile_core as r_compile_core
from repro.core.compiler import select_table as r_select_table
from repro.core.jexec import PlanExecutor as RPlanExecutor
from repro.core.modifiers import ModifierSpine as RModifierSpine
from repro.core.modifiers import peel_spine as r_peel_spine
from repro.core.sparql import parse_sparql as r_parse_sparql
from repro.core.stats import build_catalog as r_build_catalog
from repro.engine import Dataset as RDataset
from repro.engine import RuntimeConfig as RRuntimeConfig
from repro.rdf.dictionary import Dictionary as RDictionary
from repro.rdf.workloads import basic_queries as r_basic_queries

import repro_torch.analysis as T_AN
from repro_torch import Dataset, Engine, RuntimeConfig
from repro_torch.analysis import verifier as t_verifier
from repro_torch.core.compiler import Plan as TPlan
from repro_torch.core.compiler import compile_bgp as t_compile_bgp
from repro_torch.core.compiler import compile_core as t_compile_core
from repro_torch.core.compiler import select_table as t_select_table
from repro_torch.core.jexec import PlanExecutor as TPlanExecutor
from repro_torch.core.modifiers import ModifierSpine as TModifierSpine
from repro_torch.core.modifiers import peel_spine as t_peel_spine
from repro_torch.core.sparql import parse_sparql as t_parse_sparql
from repro_torch.core.stats import build_catalog as t_build_catalog
from repro_torch.engine import backends as t_backends
from repro_torch.engine import template as t_template
from repro_torch.rdf.dictionary import Dictionary as TDictionary

from _torch_dist_jobs import run_group
from test_analysis import G1_TRIPLES
from test_differential import FIXED_QUERIES, fixed_corpus_triples
from test_torch_data import port_catalog

REF = SimpleNamespace(
    an=R_AN, Plan=RPlan, compile_bgp=r_compile_bgp,
    compile_core=r_compile_core, select_table=r_select_table,
    PlanExecutor=RPlanExecutor, ModifierSpine=RModifierSpine,
    peel_spine=r_peel_spine, parse_sparql=r_parse_sparql,
    build_catalog=r_build_catalog, Dictionary=RDictionary)
PORT = SimpleNamespace(
    an=T_AN, Plan=TPlan, compile_bgp=t_compile_bgp,
    compile_core=t_compile_core, select_table=t_select_table,
    PlanExecutor=lambda *a, **k: TPlanExecutor(*a, device="cpu", **k),
    ModifierSpine=TModifierSpine, peel_spine=t_peel_spine,
    parse_sparql=t_parse_sparql, build_catalog=t_build_catalog,
    Dictionary=TDictionary)

TAUS = (0.25, 1.0)
PLANNERS = ("greedy", "estimate")


def diags(report):
    """A report as plain data: its diagnostics and the checks it ran."""
    return ([(d.rule, d.severity, d.message, d.location)
             for d in report.diagnostics], tuple(report.checks))


def both(scenario):
    """``scenario(ns)`` returns a list of reports; the port's must equal
    the reference's one for one.  Returns the port's."""
    want, got = scenario(REF), scenario(PORT)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert diags(g) == diags(w)
    return got


def fresh_g1(ns, threshold=1.0):
    d = ns.Dictionary()
    tt = d.encode_triples(G1_TRIPLES)
    return ns.build_catalog(tt, d, threshold=threshold), d


def plan_for(ns, qtext, cat, d, planner="greedy"):
    return ns.compile_bgp(ns.parse_sparql(qtext, d).root, cat,
                          planner=planner)


def error_rules(report):
    return {diag.rule for diag in report.errors}


# ---------------------------------------------------------------------------
# legitimate plans are silent
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("planner", PLANNERS)
def test_clean_plans_verify_ok(planner):
    def scenario(ns):
        cat, d = fresh_g1(ns)
        return [ns.an.verify_plan(plan_for(ns, q, cat, d, planner), cat)
                for q in (
                    "SELECT * WHERE { ?x follows ?y }",
                    "SELECT * WHERE { ?x follows ?y . ?y likes ?z }",
                    "SELECT * WHERE { ?x likes ?w . ?x follows ?y . "
                    "?y follows ?z . ?z likes ?w }")]
    for report in both(scenario):
        assert report.ok and not report.diagnostics and report.checks


def test_statistics_empty_plan_verifies():
    def scenario(ns):
        cat, d = fresh_g1(ns)
        plan = plan_for(ns, "SELECT * WHERE { ?x likes ?y . ?y follows ?z }",
                        cat, d)
        assert plan.empty
        return [ns.an.verify_plan(plan, cat)]
    assert both(scenario)[0].ok


# ---------------------------------------------------------------------------
# each invariant fires on the same corruption
# ---------------------------------------------------------------------------

def test_cross_join_rejected():
    def scenario(ns):
        cat, d = fresh_g1(ns)
        plan = plan_for(
            ns, "SELECT * WHERE { ?a follows ?b . ?b follows ?c . "
            "?c likes ?w }", cat, d)
        by_vars = {frozenset(v for v in (s.tp.s, s.tp.o)): s
                   for s in plan.steps}
        bad = ns.Plan(steps=[by_vars[frozenset({"?a", "?b"})],
                             by_vars[frozenset({"?c", "?w"})],
                             by_vars[frozenset({"?b", "?c"})]],
                      vars=plan.vars, planner=plan.planner)
        return [ns.an.verify_plan(bad, cat)]
    assert "cross-join" in error_rules(both(scenario)[0])


def _single_step(ns, mutate):
    cat, d = fresh_g1(ns)
    plan = plan_for(ns, "SELECT * WHERE { ?x follows ?y }", cat, d)
    mutate(plan)
    return [ns.an.verify_plan(plan, cat)]


def test_sf_zero_step_rejected():
    def mutate(plan):
        plan.steps[0].sf = 0.0
    report, = both(lambda ns: _single_step(ns, mutate))
    assert "sf-zero-step" in error_rules(report)


def test_empty_flag_mismatch_rejected():
    def mutate(plan):
        plan.empty = True
    report, = both(lambda ns: _single_step(ns, mutate))
    assert "empty-flag" in error_rules(report)


def test_unknown_planner_tag_rejected():
    def mutate(plan):
        plan.planner = "quantum"
    report, = both(lambda ns: _single_step(ns, mutate))
    assert "planner-tag" in error_rules(report)


def test_sentinel_collision_rejected():
    def mutate(plan):
        plan.steps[0].tp = dataclasses.replace(plan.steps[0].tp, s=-1)
    report, = both(lambda ns: _single_step(ns, mutate))
    assert "sentinel-collision" in error_rules(report)


def test_fabricated_table_stats_rejected():
    def mutate(plan):
        plan.steps[0].sf = 0.5
    report, = both(lambda ns: _single_step(ns, mutate))
    assert "table-choice" in error_rules(report)


def test_unmaterialized_extvp_choice_rejected():
    def scenario(ns):
        cat, d = fresh_g1(ns, threshold=0.25)
        follows, likes = d.term_to_id["follows"], d.term_to_id["likes"]
        assert cat.sf("SO", likes, follows) > cat.extvp.threshold
        plan = plan_for(ns, "SELECT * WHERE { ?x follows ?y . ?y likes ?z }",
                        cat, d)
        step = next(s for s in plan.steps if int(s.tp.p) == likes)
        step.kind, step.p2 = "SO", follows
        step.sf = cat.sf("SO", likes, follows)
        step.size = cat.size("SO", likes, follows)
        return [ns.an.verify_plan(plan, cat)]
    assert error_rules(both(scenario)[0]) == {"extvp-materialized"}


def test_extvp_partner_missing_rejected():
    def scenario(ns):
        cat, d = fresh_g1(ns)
        follows, likes = d.term_to_id["follows"], d.term_to_id["likes"]
        plan = plan_for(ns, "SELECT * WHERE { ?y likes ?z }", cat, d)
        step = plan.steps[0]
        step.kind, step.p2 = "SO", follows
        step.sf = cat.sf("SO", likes, follows)
        step.size = cat.size("SO", likes, follows)
        return [ns.an.verify_plan(plan, cat)]
    assert "extvp-partner" in error_rules(both(scenario)[0])


def test_flat_offset_corruption_rejected():
    def scenario(ns):
        cat, d = fresh_g1(ns)
        query = ns.parse_sparql(
            "SELECT * WHERE { { ?a follows ?b } UNION { ?a likes ?b } }", d)
        node, spine = ns.peel_spine(query)
        core = ns.compile_core(node, cat)
        core.root.right.start += 1
        return [ns.an.verify_core(core, cat, spine=spine)]
    assert "flat-offset" in error_rules(both(scenario)[0])


def test_dropped_cap_slot_rejected():
    def scenario(ns):
        cat, d = fresh_g1(ns)
        plan = plan_for(ns, "SELECT * WHERE { ?x follows ?y . ?y likes ?z }",
                        cat, d)
        ex = ns.PlanExecutor(plan, cat)
        before = ns.an.verify_executor(ex)
        ex.caps = ex.caps[:-1]
        return [before, ns.an.verify_executor(ex)]
    before, after = both(scenario)
    assert before.ok and "cap-slots" in error_rules(after)


def test_corrupted_combine_index_rejected():
    def scenario(ns):
        cat, d = fresh_g1(ns)
        query = ns.parse_sparql(
            "SELECT * WHERE { ?a follows ?b OPTIONAL { ?b likes ?w } }", d)
        node, spine = ns.peel_spine(query)
        ex = ns.PlanExecutor(ns.compile_core(node, cat), cat, spine=spine)
        before = ns.an.verify_executor(ex)
        (seg_id, slot), = ex._comb_index.items()
        ex._comb_index = {seg_id: slot + 1}
        return [before, ns.an.verify_executor(ex)]
    before, after = both(scenario)
    assert before.ok and "cap-slots" in error_rules(after)


def test_negative_slice_rejected():
    def scenario(ns):
        cat, d = fresh_g1(ns)
        plan = plan_for(ns, "SELECT * WHERE { ?x follows ?y }", cat, d)
        return [ns.an.verify_plan(plan, cat, ns.ModifierSpine(offset=-1))]
    assert "modifier-slice" in error_rules(both(scenario)[0])


def test_raise_if_failed_carries_diagnostics():
    def raised(ns):
        cat, d = fresh_g1(ns)
        plan = plan_for(ns, "SELECT * WHERE { ?x follows ?y }", cat, d)
        plan.planner = "quantum"
        with pytest.raises(ns.an.PlanVerificationError) as exc:
            ns.an.verify_plan(plan, cat).raise_if_failed()
        return exc.value
    got, want = raised(PORT), raised(REF)
    assert "planner-tag" in got.rules() and "quantum" in str(got)
    assert got.rules() == want.rules() and str(got) == str(want)


# ---------------------------------------------------------------------------
# warnings (diagnose, never reject)
# ---------------------------------------------------------------------------

def test_phantom_filter_var_warns():
    def scenario(ns):
        cat, d = fresh_g1(ns)
        node, spine = ns.peel_spine(ns.parse_sparql(
            "SELECT * WHERE { ?x follows ?y FILTER(?zz != ?x) }", d))
        return [ns.an.verify_core(ns.compile_core(node, cat), cat,
                                  spine=spine)]
    report, = both(scenario)
    assert report.ok and "filter-var" in {d.rule for d in report.warnings}


def test_phantom_projection_var_warns():
    def scenario(ns):
        cat, d = fresh_g1(ns)
        plan = plan_for(ns, "SELECT * WHERE { ?x follows ?y }", cat, d)
        return [ns.an.verify_plan(plan, cat,
                                  spine=ns.ModifierSpine(project=("?nope",)))]
    report, = both(scenario)
    assert report.ok and "projection-var" in {d.rule for d in report.warnings}
    assert "warning(s)" in report.describe()


# ---------------------------------------------------------------------------
# Algorithm 1 only credits materialized reductions
# ---------------------------------------------------------------------------

def test_select_table_skips_unmaterialized_pairs():
    def scenario(ns):
        cat, d = fresh_g1(ns, threshold=0.25)
        follows, likes = d.term_to_id["follows"], d.term_to_id["likes"]
        q = ns.parse_sparql(
            "SELECT * WHERE { ?x follows ?y . ?y likes ?z }", d)
        tps = list(q.root.patterns)
        by_pred = {int(tp.p): tp for tp in tps}
        f_step = ns.select_table(by_pred[follows], tps, cat)
        assert (f_step.kind, f_step.p2) == ("OS", likes)
        l_step = ns.select_table(by_pred[likes], tps, cat)
        assert l_step.kind is None and l_step.sf == 1.0
        return [ns.an.verify_plan(plan_for(
            ns, "SELECT * WHERE { ?x follows ?y . ?y likes ?z }", cat, d),
            cat)]
    assert both(scenario)[0].ok


def test_select_table_keeps_sf_zero_short_circuit():
    def scenario(ns):
        cat, d = fresh_g1(ns, threshold=0.25)
        plan = plan_for(ns, "SELECT * WHERE { ?x likes ?y . ?y follows ?z }",
                        cat, d)
        assert plan.empty
        return [ns.an.verify_plan(plan, cat)]
    assert both(scenario)[0].ok


def test_unverifiable_prepared_reports_skip():
    got = T_AN.verify_prepared(object(), None)
    want = R_AN.verify_prepared(object(), None)
    assert diags(got) == diags(want)
    assert got.ok and not got.checks and "skipped" in got.describe()
    assert got.describe() == want.describe()


def test_placeholder_base_is_the_template_band():
    assert t_verifier.PLACEHOLDER_BASE == t_template.PLACEHOLDER_BASE
    assert t_verifier.ALL_CHECKS == R_AN.verifier.ALL_CHECKS


# ---------------------------------------------------------------------------
# corpus sweeps: every prepared form reports what the reference reports
# ---------------------------------------------------------------------------

PORT_BACKEND = {"eager": "eager", "jit": "torch"}


def test_fixed_corpus_reports_equal_reference():
    mesh = jax.make_mesh((1,), ("data",))
    triples = fixed_corpus_triples()
    checked = 0
    for tau in TAUS:
        rds = RDataset.from_triples(triples, threshold=tau)
        ds = Dataset.from_triples(triples, threshold=tau, device="cpu")
        for planner in PLANNERS:
            for rb, tb in PORT_BACKEND.items():
                ref = rds.engine(rb, mesh=mesh, runtime=RRuntimeConfig(
                    planner=planner))
                eng = ds.engine(tb, planner=planner)
                for qtext in FIXED_QUERIES:
                    got = T_AN.verify_prepared(eng.prepare(qtext), ds.catalog)
                    want = R_AN.verify_prepared(ref.prepare(qtext),
                                                rds.catalog)
                    assert diags(got) == diags(want), \
                        (tau, planner, tb, qtext)
                    assert got.ok
                    checked += bool(got.checks)
    assert checked > 0


def test_watdiv_basic_suite_reports_equal_reference(watdiv_small):
    cat, d, sch = watdiv_small
    rds = RDataset(catalog=cat, dictionary=d, schema=sch)
    ds = Dataset(catalog=port_catalog(cat), device="cpu")
    for planner in PLANNERS:
        refs = {b: rds.engine(b, runtime=RRuntimeConfig(planner=planner))
                for b in PORT_BACKEND}
        ports = {b: ds.engine(PORT_BACKEND[b], planner=planner)
                 for b in PORT_BACKEND}
        for name, (qtext,) in r_basic_queries(sch, n_instances=1).items():
            # the core pass, as tests/test_analysis.py runs it
            core, spine = _core(REF, qtext, cat, d, planner)
            want = R_AN.verify_core(core, cat, spine=spine)
            core, spine = _core(PORT, qtext, ds.catalog, ds.dictionary,
                                planner)
            got = T_AN.verify_core(core, ds.catalog, spine=spine)
            assert diags(got) == diags(want) and got.ok, (planner, name)
            for b in PORT_BACKEND:
                got = T_AN.verify_prepared(ports[b].prepare(qtext),
                                           ds.catalog)
                want = R_AN.verify_prepared(refs[b].prepare(qtext), cat)
                assert diags(got) == diags(want), (planner, b, name)
                assert got.ok and not got.warnings, (planner, b, name)


def _core(ns, qtext, cat, d, planner):
    node, spine = ns.peel_spine(ns.parse_sparql(qtext, d))
    return ns.compile_core(node, cat, planner=planner), spine


def test_distributed_prepared_reports_equal_reference(tmp_path):
    """The port's distributed executors, built on two gloo ranks, report
    what the reference's distributed executors (one device) report."""
    mesh = jax.make_mesh((1,), ("data",))
    triples = fixed_corpus_triples()
    ranks = run_group("verify", 2, tmp_path, triples=triples,
                      taus=list(TAUS), planners=list(PLANNERS),
                      queries=FIXED_QUERIES, scale=0.1, seed=7)
    assert ranks[0] == ranks[1]
    got = ranks[0]
    for tau in TAUS:
        rds = RDataset.from_triples(triples, threshold=tau)
        for planner in PLANNERS:
            ref = rds.engine("distributed", mesh=mesh,
                             runtime=RRuntimeConfig(planner=planner))
            for qtext in FIXED_QUERIES:
                want = diags(R_AN.verify_prepared(ref.prepare(qtext),
                                                  rds.catalog))
                assert got["corpus"][f"{tau}|{planner}|{qtext}"] == want, \
                    (tau, planner, qtext)
    rds = RDataset.watdiv(scale=0.1, seed=7, threshold=1.0)
    for planner in PLANNERS:
        ref = rds.engine("distributed", mesh=mesh,
                         runtime=RRuntimeConfig(planner=planner))
        for name, (qtext,) in r_basic_queries(rds.schema,
                                              n_instances=1).items():
            want = diags(R_AN.verify_prepared(ref.prepare(qtext),
                                              rds.catalog))
            assert got["watdiv"][f"{planner}|{name}"] == want, \
                (planner, name)
            assert want[1] and not want[0], (planner, name)


# ---------------------------------------------------------------------------
# engine integration
# ---------------------------------------------------------------------------

def test_config_knob_reads_the_reference_env(monkeypatch):
    monkeypatch.setenv("REPRO_RT_VERIFY_PLANS", "0")
    assert RuntimeConfig().verify_plans is False
    monkeypatch.setenv("REPRO_RT_VERIFY_PLANS", "1")
    assert RuntimeConfig().verify_plans is True
    monkeypatch.delenv("REPRO_RT_VERIFY_PLANS")
    assert RuntimeConfig().verify_plans is False
    cfg = RuntimeConfig(verify_plans=True)
    assert cfg.verify_plans is True and "verify_plans" in cfg.snapshot()


def test_explain_verdict_equals_reference(watdiv_small):
    """``explain()``'s last line is the verifier's verdict, the
    reference's wording, on the torch, eager and ``pt`` (the eager
    fallback: nothing to verify) engines, with the knob off."""
    cat, d, sch = watdiv_small
    rds = RDataset(catalog=cat, dictionary=d, schema=sch)
    ds = Dataset(catalog=port_catalog(cat), device="cpu")
    off_ref = RRuntimeConfig(verify_plans=False)
    off = RuntimeConfig(verify_plans=False)
    pairs = [(rds.engine("jit", runtime=off_ref),
              ds.engine("torch", runtime=off)),
             (rds.engine("eager", runtime=off_ref),
              ds.engine("eager", runtime=off)),
             (rds.engine("jit", layout="pt", runtime=off_ref),
              ds.engine("torch", layout="pt", runtime=off))]
    queries = [q[0] for q in r_basic_queries(sch, seed=0).values()]
    queries += ["SELECT * WHERE { ?u wsdbm:likes ?p "
                "OPTIONAL { ?p sorg:caption ?c } }"]
    seen = set()
    for ref, eng in pairs:
        for qtext in queries:
            got = eng.explain(qtext).splitlines()[-1]
            assert got == ref.explain(qtext).splitlines()[-1], qtext
            assert got.startswith("verify: ")
            seen.add(got.split(" (")[0])
    assert seen == {"verify: ok", "verify: skipped"}


def _corrupting(monkeypatch):
    """Every executor the torch backend builds loses its last cap slot —
    the corruption of ``test_dropped_cap_slot_rejected`` — and every
    launch is recorded."""
    inner = t_backends.TorchBackend._prepared
    launched = []

    def corrupt(self, template, ctx, cp, spine):
        prepared = inner(self, template, ctx, cp, spine)
        prepared.executor.caps = prepared.executor.caps[:-1]
        return prepared

    monkeypatch.setattr(t_backends.TorchBackend, "_prepared", corrupt)
    monkeypatch.setattr(TPlanExecutor, "_launch",
                        lambda *a, **k: launched.append(1))
    return launched


def test_knob_raises_before_cache_and_launch(monkeypatch):
    launched = _corrupting(monkeypatch)
    ds = Dataset.from_triples(G1_TRIPLES, device="cpu")
    q = "SELECT * WHERE { ?x <follows> ?y . ?y <likes> ?z }"
    eng = Engine(ds, runtime=RuntimeConfig(verify_plans=True), device="cpu")
    with pytest.raises(T_AN.PlanVerificationError) as exc:
        eng.query(q)
    assert "cap-slots" in exc.value.rules()
    with pytest.raises(T_AN.PlanVerificationError):
        eng.query_batch([q, q])
    assert len(eng.cache) == 0 and launched == []
    # with the knob off the plan is cached, and explain() still reports
    # the verdict
    off = Engine(ds, runtime=RuntimeConfig(verify_plans=False), device="cpu")
    verdict = off.explain(q).splitlines()[-1]
    assert verdict.startswith("verify: FAILED") and "cap-slots" in verdict
    assert len(off.cache) == 1 and launched == []


def test_knob_opens_a_verify_span():
    ds = Dataset.from_triples(G1_TRIPLES, device="cpu")
    eng = Engine(ds, runtime=RuntimeConfig(verify_plans=True,
                                           trace_sample_rate=1.0),
                 device="cpu")
    eng.query("SELECT * WHERE { ?x <follows> ?y }")
    assert '"verify"' in eng.tracer.to_jsonl()


def test_lazy_store_loads_no_table_under_verification(tmp_path):
    src = Dataset.watdiv(scale=0.1, seed=7, threshold=0.25, device="cpu")
    src.save(str(tmp_path / "store"))
    ds = Dataset.load(str(tmp_path / "store"), device="cpu")
    cat = ds.catalog
    reports = []
    for backend in ("torch", "eager"):
        eng = ds.engine(backend, runtime=RuntimeConfig(verify_plans=False))
        for name, insts in r_basic_queries(src.schema, seed=0).items():
            prepared = eng.prepare(insts[0])
            before = (cat.vp.n_loaded, cat.extvp.tables.n_loaded)
            reports.append(T_AN.verify_prepared(prepared, cat))
            assert (cat.vp.n_loaded, cat.extvp.tables.n_loaded) == before, \
                (backend, name)
    assert all(r.ok for r in reports)
    assert cat.vp.n_loaded < len(cat.vp)
