"""The port's adaptive runtime against the JAX package's, case for case
with ``tests/test_runtime.py``.

* ``RuntimeConfig``, ``BackendRouter`` and ``BatchTuner``: every
  scripted observation stream is fed to both packages' objects, and the
  decisions, logs and ``report()`` dicts must be equal, besides holding
  the reference test's own property.
* ``Engine(backend="auto")`` and ``SparqlServer(backend="auto")`` on
  the port: answers equal the eager oracle's, failing and fallback
  backends are excluded, the report has the reference's shape.
* The port's and the reference's auto engines serve the same requests
  under scripted latencies and route identically (``jit`` ↔ ``torch``).
* CUDA and kernel-build errors raise: they never become a host fallback
  or a routing exclusion.
* Two gloo ranks with different clocks route every request alike.
"""

import json

import pytest
import torch

from repro.engine import Dataset as RDataset
from repro.runtime import BackendRouter as RBackendRouter
from repro.runtime import BatchTuner as RBatchTuner
from repro.runtime import RouteDecision as RRouteDecision
from repro.runtime import RuntimeConfig as RRuntimeConfig

from repro_torch import Dataset
from repro_torch.engine import template_signature
from repro_torch.kernels.build import KernelBuildError
from repro_torch.kernels.ops import KernelLaunchError
from repro_torch.runtime import (
    BackendRouter, BatchTuner, RouteDecision, RuntimeConfig,
)

from _torch_dist_jobs import run_group
from test_torch_data import port_catalog

PORT = {"RuntimeConfig": RuntimeConfig, "BackendRouter": BackendRouter,
        "BatchTuner": BatchTuner, "RouteDecision": RouteDecision}
REF = {"RuntimeConfig": lambda **kw: RRuntimeConfig(verify_plans=False,
                                                    **kw),
       "BackendRouter": RBackendRouter, "BatchTuner": RBatchTuner,
       "RouteDecision": RRouteDecision}


class FakeClock:
    """Deterministic time source; advances only when told to."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, seconds):
        self.t += seconds


def both(scenario):
    """``scenario(ns)`` on the port's classes and on the reference's;
    the outputs must be equal.  Returns the port's."""
    got, want = scenario(PORT), scenario(REF)
    assert got == want
    return got


def _cfg(ns, **kw):
    kw.setdefault("clock", FakeClock())
    return ns["RuntimeConfig"](**kw)


SIG = "SELECT * WHERE { ?u <p> ?v }"
DEVICE = "jit"          # the device backend's name in both scripted streams


def _drive(router, sig, latencies, n):
    """Run n scripted requests: decide, then observe the scripted
    latency of whichever backend was chosen."""
    out = []
    for _ in range(n):
        d = router.decide(sig)
        router.observe(sig, d.backend, latencies[d.backend],
                       reason=d.reason)
        out.append((d.backend, d.reason))
    return out


def _router(ns, **kw):
    return ns["BackendRouter"](("eager", DEVICE), _cfg(ns, **kw))


# ---------------------------------------------------------------------------
# RuntimeConfig
# ---------------------------------------------------------------------------

def test_config_env_overrides(monkeypatch):
    monkeypatch.setenv("REPRO_RT_WARMUP", "7")
    monkeypatch.setenv("REPRO_RT_BATCH_SHAPES", "8,1,4")
    got = both(lambda ns: (ns["RuntimeConfig"]().router_warmup,
                           ns["RuntimeConfig"]().batch_shapes))
    assert got == (7, (1, 4, 8))                # sorted, deduped


def test_config_kwargs_beat_env(monkeypatch):
    monkeypatch.setenv("REPRO_RT_WARMUP", "7")
    assert both(lambda ns: ns["RuntimeConfig"](
        router_warmup=3).router_warmup) == 3


def test_config_unknown_knob_raises():
    for ns in (PORT, REF):
        with pytest.raises(ValueError, match="unknown RuntimeConfig knob"):
            ns["RuntimeConfig"](router_warmupp=3)


def test_config_bad_shapes_raise(monkeypatch):
    for ns in (PORT, REF):
        with pytest.raises(ValueError):
            ns["RuntimeConfig"](batch_shapes=())
    monkeypatch.setenv("REPRO_RT_BATCH_SHAPES", "0,4")
    for ns in (PORT, REF):
        with pytest.raises(ValueError):
            ns["RuntimeConfig"]()


def test_config_snapshot_equals_reference_on_shared_keys():
    t = RuntimeConfig(batch_shapes=(1, 2)).snapshot()
    r = RRuntimeConfig(batch_shapes=(1, 2)).snapshot()
    assert "clock" not in t and t["batch_shapes"] == [1, 2]
    json.dumps(t)                                # must not raise
    # the port has every knob of the reference, the plan verifier's too
    assert set(r) == set(t)
    assert {k: r[k] for k in t} == t


# ---------------------------------------------------------------------------
# BackendRouter: scripted-latency unit tests
# ---------------------------------------------------------------------------

def _report(r):
    rep = r.report()
    return rep["backends"], rep["signatures"], rep["decisions"]


def test_router_converges_to_fast_backend():
    def run(ns):
        r = _router(ns, router_warmup=2, router_discard=1,
                    router_probe_every=0)
        return _drive(r, SIG, {"eager": 1.0, DEVICE: 0.2}, 12), _report(r)
    decisions, (_, sigs, _) = both(run)
    assert [d[1] for d in decisions[:6]] == ["warmup"] * 6
    assert all(d == (DEVICE, "measured") for d in decisions[6:])
    st = sigs[SIG]
    assert st["choice"] == DEVICE and st["reason"] == "measured"
    assert st["samples"]["eager"] == 3 and st["samples"][DEVICE] == 9


def test_router_decisions_deterministic():
    def run(ns):
        r = _router(ns, router_warmup=1, router_discard=0,
                    router_probe_every=4)
        return _drive(r, SIG, {"eager": 0.4, DEVICE: 0.9}, 20), _report(r)
    assert both(run) == both(run)


def test_router_discard_excludes_compile_sample():
    def run(ns):
        r = _router(ns, router_warmup=1, router_discard=1,
                    router_probe_every=0)
        r.observe(SIG, DEVICE, 250.0)
        r.observe(SIG, DEVICE, 0.2)
        r.observe(SIG, "eager", 1.0)
        r.observe(SIG, "eager", 1.0)
        d = r.decide(SIG)
        return (d.backend, d.reason), _report(r)
    d, (_, sigs, _) = both(run)
    assert sigs[SIG]["ewma_ms"][DEVICE] == pytest.approx(0.2)
    assert d == (DEVICE, "measured")


def test_router_winner_drift_switches_seat():
    def run(ns):
        r = _router(ns, router_warmup=1, router_discard=0, router_alpha=0.5,
                    router_probe_every=0)
        lat = {"eager": 1.0, DEVICE: 0.2}
        first = _drive(r, SIG, lat, 4)
        seat = r.peek(SIG).backend
        lat[DEVICE] = 6.0                        # drift: the device degrades
        return first, seat, _drive(r, SIG, lat, 6), _report(r)
    _, seat, decisions, (_, sigs, _) = both(run)
    assert seat == DEVICE
    assert decisions[-1] == ("eager", "measured")
    assert sigs[SIG]["switches"] >= 1


def test_router_probe_rediscovers_improved_loser():
    def run(ns):
        r = _router(ns, router_warmup=1, router_discard=0, router_alpha=0.5,
                    router_probe_every=4)
        lat = {"eager": 0.3, DEVICE: 2.0}
        first = _drive(r, SIG, lat, 3)
        seat = r.peek(SIG).backend
        lat[DEVICE] = 0.05                       # the loser improves
        return first, seat, _drive(r, SIG, lat, 12), r.peek(SIG).backend, \
            _report(r)
    _, seat, decisions, final, _ = both(run)
    assert seat == "eager"
    assert (DEVICE, "probe") in decisions
    assert final == DEVICE


def test_router_never_routes_to_excluded_backend():
    def run(ns):
        r = _router(ns, router_warmup=2, router_probe_every=2)
        r.mark_failed(SIG, DEVICE)
        a = _drive(r, SIG, {"eager": 1.0, DEVICE: 0.1}, 16)
        r2 = _router(ns, router_warmup=2, router_probe_every=2)
        r2.mark_fallback(SIG, DEVICE)
        b = _drive(r2, SIG, {"eager": 1.0, DEVICE: 0.1}, 16)
        return a, b, _report(r), _report(r2)
    a, b, _, _ = both(run)
    assert all(d[0] == "eager" for d in a + b)


def test_router_exclusion_is_per_signature():
    other = "SELECT * WHERE { ?a <q> ?b }"

    def run(ns):
        r = _router(ns, router_warmup=1, router_discard=0)
        r.mark_failed(SIG, DEVICE)
        return r.eligible(other), r.eligible(SIG)
    assert both(run) == (["eager", DEVICE], ["eager"])


def test_router_decision_log_bounded():
    def run(ns):
        r = _router(ns, router_log_size=8, router_warmup=1, router_discard=0)
        _drive(r, SIG, {"eager": 1.0, DEVICE: 0.5}, 50)
        return _report(r)
    assert len(both(run)[2]) == 8


def test_router_batched_groups_and_readmits():
    """Micro-batch groups (``decide(n=...)``, weighted observations) and
    the periodic re-admission of fallback exclusions."""
    def run(ns):
        r = _router(ns, router_warmup=1, router_discard=0,
                    router_probe_every=8, router_readmit_every=5)
        out = []
        for i in range(12):
            if i == 2:
                r.mark_fallback(SIG, DEVICE)
            d = r.decide(SIG, n=3)
            r.observe(SIG, d.backend, {"eager": 1.5, DEVICE: 0.4}[d.backend],
                      reason=d.reason, weight=3)
            out.append((d.backend, d.reason, r.estimates(SIG)))
        return out, r.routed_counts(), _report(r)
    out, routed, (_, sigs, _) = both(run)
    assert sigs[SIG]["readmits"] > 0
    assert sum(routed.values()) == 36


# ---------------------------------------------------------------------------
# BatchTuner: scripted-launch unit tests
# ---------------------------------------------------------------------------

def test_tuner_retires_measured_slow_bucket():
    def run(ns):
        t = ns["BatchTuner"]((1, 8, 32), _cfg(ns, tuner_min_samples=3,
                                              tuner_discard=1,
                                              tuner_margin=1.1))
        for _ in range(4):
            t.observe(8, 8, 8 * 0.1)
            t.observe(32, 20, 32 * 0.25)
        return t.active_shapes(), t.max_shape(), t.bucket_for(20), \
            t.report()
    active, top, bucket, rep = both(run)
    assert active == (1, 8) and top == 8 and bucket == 8
    assert "32" in rep["retired"] and rep["buckets"]["32"]["retired"]


def test_tuner_needs_min_samples_before_retiring():
    def run(ns):
        t = ns["BatchTuner"]((8, 32), _cfg(ns, tuner_min_samples=3,
                                           tuner_discard=0,
                                           tuner_margin=1.1))
        for _ in range(2):
            t.observe(8, 8, 0.8)
            t.observe(32, 32, 32.0)
        return t.active_shapes(), t.report()
    assert both(run)[0] == (8, 32)


def test_tuner_smallest_shape_never_retired():
    def run(ns):
        t = ns["BatchTuner"]((1, 4), _cfg(ns, tuner_min_samples=1,
                                          tuner_discard=0, tuner_margin=1.0))
        for _ in range(5):
            t.observe(1, 1, 50.0)
            t.observe(4, 4, 0.4)
        return t.active_shapes(), t.report()
    assert 1 in both(run)[0]


def test_tuner_discard_excludes_compile_launch():
    def run(ns):
        t = ns["BatchTuner"]((4, 8), _cfg(ns, tuner_min_samples=1,
                                          tuner_discard=1, tuner_margin=1.5))
        t.observe(8, 8, 800.0)
        t.observe(8, 8, 0.8)
        return t.report()
    assert both(run)["buckets"]["8"]["per_slot_ms"] == pytest.approx(0.1)


def test_tuner_bucket_for_matches_menu():
    def run(ns):
        t = ns["BatchTuner"]((1, 2, 4, 8, 16, 32), _cfg(ns))
        return [t.bucket_for(n) for n in (1, 2, 3, 5, 8, 9, 32, 100)]
    assert both(run) == [1, 2, 4, 8, 8, 16, 32, 32]


# ---------------------------------------------------------------------------
# Engine integration: backend="auto" on the port
# ---------------------------------------------------------------------------

Q_FOLLOWS = ("SELECT * WHERE {{ wsdbm:User{0} wsdbm:follows ?v . "
             "?v sorg:email ?e }}")
Q_LIKES = ("SELECT ?p WHERE {{ wsdbm:User{0} wsdbm:likes ?v . "
           "?v sorg:price ?p }}")
Q_PT = "SELECT * WHERE { ?v0 wsdbm:likes ?v1 }"


@pytest.fixture(scope="module")
def pair(watdiv_small):
    cat, d, sch = watdiv_small
    rds = RDataset(catalog=cat, dictionary=d, schema=sch)
    return rds, Dataset(catalog=port_catalog(cat), device="cpu")


@pytest.fixture
def ds(pair):
    yield pair[1]
    pair[1]._engines.clear()


def test_auto_batched_matches_sequential_eager(pair):
    """Auto answers equal the eager oracle's, singly and batched, and
    both backends serve.  Under one scripted latency per backend the
    reference's auto engine serves the same script: a batch routed to the
    card is one launch sequence in both packages, so both pad it to its
    bucket shape and feed the tuner alike."""
    rds, ds = pair
    knobs = dict(router_warmup=1, router_discard=0, router_probe_every=3)
    script = {"eager": 3.0, "jit": 0.75, "torch": 0.75}
    rclock, tclock = FakeClock(), FakeClock()
    ref = rds.engine("auto", runtime=RRuntimeConfig(
        clock=rclock, verify_plans=False, **knobs))
    eng = ds.engine("auto", runtime=RuntimeConfig(clock=tclock, **knobs))
    ScriptedLatency(ref, rclock, script)
    ScriptedLatency(eng, tclock, script)
    oracle = ds.engine("eager")
    queries = [Q_FOLLOWS.format(u % 7) for u in range(11)] + \
              [Q_LIKES.format(u % 5) for u in range(9)]
    for q in queries:
        assert eng.query(q).same_as(oracle.query(q)), q
        ref.query(q)
    # the batch groups go to each signature's seat (a probe would send a
    # whole group to the loser)
    eng.config.router_probe_every = ref.config.router_probe_every = 0
    for q, got, want in zip(queries, eng.query_batch(queries),
                            ref.query_batch(queries)):
        assert got.same_as(oracle.query(q)), q
        assert got.same_as(want), q
    rep = eng.runtime_report()
    assert rep["backend"] == "auto" and rep["auto"]
    routed = rep["metrics"]["routed"]
    assert routed.get("eager", 0) > 0 and routed.get("torch", 0) > 0
    assert _routes(eng) == _routes(ref)
    # a batch that is one launch sequence is padded and observed, as the
    # reference's is
    rm = ref.metrics.summary()
    assert rep["metrics"]["padding_waste"] == rm["padding_waste"] > 0
    assert rep["metrics"]["batch_occupancy"] == rm["batch_occupancy"]
    assert eng.tuner.report() == json.loads(json.dumps(ref.tuner.report()))
    assert any(b["launches"] > 0 for b in rep["tuner"]["buckets"].values())
    ds._engines.clear()
    rds._engines.clear()


def test_auto_never_routes_to_failing_backend(ds):
    eng = ds.engine("auto", runtime=RuntimeConfig(router_warmup=1,
                                                  router_discard=0))
    oracle = ds.engine("eager")

    def boom(template, ctx):
        raise RuntimeError("injected prepare failure")

    eng._backends["torch"].prepare = boom
    q = Q_FOLLOWS.format(1)
    for _ in range(6):
        assert eng.query(q).same_as(oracle.query(q))
    st = eng.router.report()["signatures"][template_signature(q)]
    assert st["failed"] == ["torch"]
    assert eng.metrics.routed == {"eager": 6}


@pytest.mark.parametrize("error", [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    torch.AcceleratorError("CUDA error: an illegal memory access was "
                           "encountered"),
    KernelBuildError("nvcc failed for join_probe.cu (exit 1)"),
    KernelLaunchError("join_probe kernel launch failed: CUDA error 700"),
], ids=["oom", "cuda-error", "kernel-build", "kernel-launch"])
def test_device_errors_raise_and_are_never_excluded(ds, error):
    """A fault of the card or of a kernel is not a template the device
    path cannot express: it propagates from ``auto`` (no ``failed``
    exclusion, no quiet move to eager) and from a static torch engine
    (no eager fallback)."""
    from repro_torch.engine import backends

    eng = ds.engine("auto", runtime=RuntimeConfig(router_warmup=1,
                                                  router_discard=0))
    q = Q_FOLLOWS.format(1)
    eng.query(q)                                 # warmup: eager first

    def boom(template, ctx):
        raise error

    eng._backends["torch"].prepare = boom
    with pytest.raises(type(error)):
        eng.query(q)                             # warmup: torch next
    st = eng.router.report()["signatures"][template_signature(q)]
    assert st["failed"] == [] and st["fallback"] == []

    static = ds.engine(runtime=RuntimeConfig())
    real = backends.PlanExecutor

    def failing_executor(*a, **k):
        raise error

    backends.PlanExecutor = failing_executor
    try:
        with pytest.raises(type(error)):
            static.query(q)
    finally:
        backends.PlanExecutor = real
    assert static.metrics.device_fallbacks == 0 and len(static.cache) == 0
    static.query(q)
    assert static.prepare(q).backend == "torch"
    assert static.metrics.device_fallbacks == 0


@pytest.mark.parametrize("error", [
    NotImplementedError("an operator the executor has not written"),
    RuntimeError("a prepare bug"),
], ids=["not-implemented", "runtime-error"])
def test_static_engine_falls_back_only_on_device_unsupported(ds, error):
    """The static torch engine prepares an eager fallback only for a
    template the device path cannot express (``DeviceUnsupported``);
    any other error while building the executor, a bare
    NotImplementedError included, reaches the caller."""
    from repro_torch.core.compiler import DeviceUnsupported
    from repro_torch.engine import backends

    static = ds.engine(runtime=RuntimeConfig())
    q = Q_FOLLOWS.format(1)
    real = backends.PlanExecutor

    def failing_executor(*a, **k):
        raise error

    backends.PlanExecutor = failing_executor
    try:
        with pytest.raises(type(error)):
            static.query(q)
        assert static.metrics.device_fallbacks == 0

        def unsupported(*a, **k):
            raise DeviceUnsupported("numeric keys defeat the pairs")

        backends.PlanExecutor = unsupported
        assert static.query(q).same_as(ds.engine("eager").query(q))
    finally:
        backends.PlanExecutor = real
    assert static.prepare(q).fallback
    assert static.metrics.device_fallbacks == 1


def test_auto_excludes_device_fallback_preparations(ds):
    eng = ds.engine("auto", layout="pt", runtime=RuntimeConfig(
        router_warmup=1, router_discard=0))
    for _ in range(4):
        eng.query(Q_PT)
    st = eng.router.report()["signatures"][template_signature(Q_PT)]
    assert st["fallback"] == ["torch"]
    assert st["choice"] == "eager"
    assert eng.metrics.device_fallbacks == 0


def test_auto_readmits_fallback_exclusions(ds):
    eng = ds.engine("auto", layout="pt", runtime=RuntimeConfig(
        router_warmup=1, router_discard=0, router_readmit_every=6))
    for _ in range(14):
        eng.query(Q_PT)
    st = eng.router.report()["signatures"][template_signature(Q_PT)]
    assert st["readmits"] == 2
    assert st["fallback"] == ["torch"]
    assert st["choice"] == "eager"
    assert eng.metrics.device_fallbacks == 0
    eng2 = ds.engine("auto", layout="pt", runtime=RuntimeConfig(
        router_warmup=1, router_discard=0, router_readmit_every=0))
    for _ in range(14):
        eng2.query(Q_PT)
    st2 = eng2.router.report()["signatures"][template_signature(Q_PT)]
    assert st2["readmits"] == 0
    assert st2["fallback"] == ["torch"]


def test_explain_reports_plan_and_route(ds):
    eng = ds.engine("auto", runtime=RuntimeConfig(router_warmup=1,
                                                  router_discard=0))
    q = Q_FOLLOWS.format(2)
    text = eng.explain(q)
    assert "backend: " in text and "(warmup" in text
    for _ in range(4):
        eng.query(q)
    text = eng.explain(q)
    assert "(measured; measured " in text or "(probe" in text
    assert "backend: eager (forced)" in ds.engine("eager").explain(q)
    pt = ds.engine(layout="pt").explain(Q_PT)
    assert "note: prepared as an eager fallback" in pt


def test_engine_default_config_is_shared_global(ds):
    from repro_torch.runtime.config import runtime_config
    assert ds.engine("eager").config is runtime_config


def test_runtime_report_shape(ds):
    eng = ds.engine("auto", runtime=RuntimeConfig())
    eng.query(Q_FOLLOWS.format(3))
    rep = eng.runtime_report()
    assert set(rep) == {"backend", "auto", "planner", "router", "tuner",
                        "config", "metrics"}
    assert rep["planner"] == "greedy"
    assert set(rep["router"]) == {"backends", "signatures", "decisions"}
    assert rep["router"]["backends"] == ["eager", "torch"]
    assert set(rep["tuner"]) == {"menu", "active", "retired", "buckets"}
    json.dumps(rep)


def test_retired_shape_shrinks_batcher_bound(ds):
    from repro_torch.serve import MicroBatcher
    eng = ds.engine("auto", runtime=RuntimeConfig(
        tuner_min_samples=1, tuner_discard=0), batch_shapes=(1, 4, 16))
    for _ in range(2):
        eng.tuner.observe(4, 4, 0.4)
        eng.tuner.observe(16, 16, 8.0)
    assert eng.max_active_batch() == 4
    b = MicroBatcher(eng, max_batch=32)
    assert b.effective_max_batch() == 4


def test_unknown_backend_rejected(ds):
    with pytest.raises(ValueError, match="unknown backend"):
        ds.engine("jit")


# ---------------------------------------------------------------------------
# The port's auto engine routes as the reference's
# ---------------------------------------------------------------------------

class ScriptedLatency:
    """Wraps every prepared query an engine's backends hand out, so that
    a run advances the engine's fake clock by the backend's scripted
    latency (ms) — the same script for both packages."""

    def __init__(self, engine, clock, latencies):
        for name, backend in engine._backends.items():
            prepare = backend.prepare

            def wrapped(template, ctx, prepare=prepare):
                prepared = prepare(template, ctx)
                run, run_batch = prepared.run, prepared.run_batch
                ms = latencies[prepared.backend]

                def timed_run(*a, **k):
                    out = run(*a, **k)
                    clock.advance(ms / 1e3)
                    return out

                def timed_batch(bindings, *a, **k):
                    out = run_batch(bindings, *a, **k)
                    clock.advance(ms * len(bindings) / 1e3)
                    return out

                prepared.run, prepared.run_batch = timed_run, timed_batch
                return prepared

            backend.prepare = wrapped


def _routes(eng):
    return [(e["backend"].replace("jit", "torch"), e["reason"], e["ms"],
             e["weight"]) for e in eng.router.log]


def test_port_and_reference_auto_route_identically(pair):
    rds, ds = pair
    knobs = dict(router_warmup=2, router_discard=1, router_probe_every=5,
                 router_alpha=0.4)
    script = {"eager": 3.0, "jit": 0.75, "torch": 0.75}
    rclock, tclock = FakeClock(), FakeClock()
    ref = rds.engine("auto", runtime=RRuntimeConfig(
        clock=rclock, verify_plans=False, **knobs))
    eng = ds.engine("auto", runtime=RuntimeConfig(clock=tclock, **knobs))
    ScriptedLatency(ref, rclock, script)
    ScriptedLatency(eng, tclock, script)
    queries = [Q_FOLLOWS.format(u % 4) for u in range(9)] + \
              [Q_LIKES.format(u % 3) for u in range(7)]
    for q in queries:
        r, t = ref.query(q), eng.query(q)
        assert t.same_as(r), q
    # groups of 8 and 4: batch shapes of the menu
    batch = queries[:8] + queries[9:13]
    for r, t in zip(ref.query_batch(batch), eng.query_batch(batch)):
        assert t.same_as(r)
    assert _routes(eng) == _routes(ref)
    want = json.loads(json.dumps(ref.router.report()).replace('"jit"',
                                                              '"torch"'))
    assert eng.router.report() == want
    assert eng.tuner.report() == json.loads(json.dumps(ref.tuner.report()))
    rm, tm = ref.metrics.summary(), eng.metrics.summary()
    assert tm["routed"] == {k.replace("jit", "torch"): v
                            for k, v in rm["routed"].items()}
    ds._engines.clear()
    rds._engines.clear()


# ---------------------------------------------------------------------------
# SparqlServer integration
# ---------------------------------------------------------------------------

def test_server_auto_end_to_end(pair):
    from repro_torch.serve import SparqlServer
    _, ds = pair
    srv = SparqlServer(ds, backend="auto", runtime=RuntimeConfig(
        router_warmup=1, router_discard=0))
    oracle = SparqlServer(ds, backend="eager", runtime=RuntimeConfig())
    queries = [Q_FOLLOWS.format(u % 6) for u in range(10)]
    tickets = [srv.submit(q) for q in queries]
    srv.flush()
    for q, t in zip(queries, tickets):
        assert t.done() and t.result().same_as(oracle.query(q))
    rep = srv.runtime_report()
    assert rep["backend"] == "auto"
    assert rep["metrics"]["served"] == 10
    assert template_signature(queries[0]) in rep["router"]["signatures"]
    assert srv.metrics.runtime_report()["backend"] == "auto"
    text = srv.metrics.prometheus()
    assert "repro_router_requests{sig=" in text
    assert "repro_tuner_shape_active" in text


def test_server_rejects_unknown_backend(pair):
    from repro_torch.serve import SparqlServer
    _, ds = pair
    with pytest.raises(ValueError, match="unknown backend"):
        SparqlServer(ds.catalog, backend="warp", device="cpu")


# ---------------------------------------------------------------------------
# Two ranks under auto
# ---------------------------------------------------------------------------

def test_two_ranks_route_alike_under_different_clocks(tmp_path):
    """Each rank's scripted clock would crown another backend (rank 0
    sees torch fastest, rank 1 eager); the engine max-reduces every
    measured latency over the group, so both ranks make the same
    decision for every request — the distributed seat's collectives
    stay paired — and every answer equals the single-device engine's."""
    ranks = run_group("auto_routing", 2, tmp_path, scale=0.05,
                      instances=12)
    assert ranks[0]["routes"] == ranks[1]["routes"]
    assert ranks[0]["report"] == ranks[1]["report"]
    backends = {b for b, _ in ranks[0]["routes"]}
    assert backends == {"eager", "torch", "distributed"}
    # the agreed latencies are the largest of each backend's script
    assert ranks[0]["report"]["ewma"] == pytest.approx(
        {"eager": 5.0, "torch": 3.0, "distributed": 4.0})
    assert ranks[0]["seat"] == "torch"
    assert all(r["equal"] == r["requests"] > 0 for r in ranks)
