"""The port's serving layer (``repro_torch.serve``, ``launch/serve.py``)
against the JAX package's ``SparqlServer(backend="jit")``: the cases of
``tests/test_serve.py`` and the batcher half of ``tests/test_batching.py``
(submit/flush/demux, full-bucket flush, a ticket forcing its own group,
the latency flush on submit, no starvation, a failed batch resolving its
tickets with the error), every served result held against the
reference's row for row.  Also: booting from a store path, two gloo
ranks submitting and flushing through the server (where only the size
bound and forced flushes drain buckets), and the launcher run as a
subprocess on the CPU with its dumps read by ``tools/trace_inspect.py``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.rdf.workloads import ST_QUERIES, basic_queries
from repro.serve import SparqlServer as RSparqlServer

from repro_torch import Dataset, RuntimeConfig, SparqlServer
from repro_torch.serve.engine import template_signature

from _torch_dist_jobs import run_group
from test_torch_data import port_catalog

ROOT = Path(__file__).resolve().parents[1]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, seconds):
        self.t += seconds


@pytest.fixture(scope="module")
def cats(watdiv_small):
    cat, _, sch = watdiv_small
    return cat, port_catalog(cat), sch


def server(cats, **kw):
    kw.setdefault("device", "cpu")
    return SparqlServer(cats[1], **kw)


@pytest.fixture(scope="module")
def ref(cats):
    return RSparqlServer(cats[0], backend="jit")


def assert_same(ref_res, res, q):
    assert res.cols == ref_res.cols, q
    assert res.data.dtype == np.int32
    np.testing.assert_array_equal(res.data, ref_res.data, err_msg=q)


def _instances(n, start=1):
    return [f"SELECT * WHERE {{ wsdbm:User{u} wsdbm:follows ?v . "
            f"?v sorg:email ?e }}" for u in range(start, start + n)]


MIXED_BATCH = (
    _instances(4)
    + ["SELECT * WHERE { wsdbm:User999999 wsdbm:follows ?v . "
       "?v sorg:email ?e }",                                  # missing const
       "SELECT * WHERE { ?p sorg:price ?x . ?x wsdbm:follows ?y }",  # empty
       "SELECT * WHERE { ?u wsdbm:likes ?p }"]                # 2nd template
)


# ---------------------------------------------------------------------------
# tests/test_serve.py
# ---------------------------------------------------------------------------

def test_template_signature_normalizes_constants():
    a = template_signature(
        "SELECT * WHERE { ?v0 wsdbm:likes wsdbm:Product3 . ?v0 sorg:email ?e }")
    b = template_signature(
        "SELECT * WHERE { ?v0 wsdbm:likes wsdbm:Product77 . ?v0 sorg:email ?e }")
    c = template_signature(
        "SELECT * WHERE { ?v0 wsdbm:follows wsdbm:User1 . ?v0 sorg:email ?e }")
    assert a == b and a != c


def test_serving_metrics_and_cache(cats, ref):
    """Rows against ``jit``; the counters against a fresh reference
    server (its eager backend keeps the same plan-cache and
    short-circuit books without compiling)."""
    srv = server(cats)
    rsrv = RSparqlServer(cats[0], backend="eager")
    reqs = []
    for insts in basic_queries(cats[2], seed=3, n_instances=3).values():
        reqs.extend(insts)
    reqs.extend(ST_QUERIES.values())
    for q in reqs:
        assert_same(ref.query(q), srv.query(q), q)
        rsrv.query(q)
    m, rm = srv.metrics.summary(), rsrv.metrics.summary()
    assert m["served"] == len(reqs)
    for k in ("served", "rows", "empties", "short_circuits",
              "plan_hit_rate", "device_fallbacks"):
        assert m[k] == rm[k], k
    assert m["plan_hit_rate"] > 0.3 and m["empties"] >= 2
    assert m["p50_ms"] >= 0 and m["routed"] == {"torch": len(reqs)}


def test_backend_parity_with_jit(cats, ref):
    srv = server(cats)
    for q in ["SELECT * WHERE { ?u wsdbm:follows ?v . ?v wsdbm:likes ?p }",
              "SELECT * WHERE { ?u sorg:email ?e . ?u foaf:age ?a }",
              "SELECT * WHERE { ?p sorg:price ?x . ?x wsdbm:follows ?y }"]:
        assert_same(ref.query(q), srv.query(q), q)


def test_executor_reuse(cats):
    srv = server(cats)
    srv.query(_instances(1)[0])
    n = len(srv.engine.cache)
    srv.query(_instances(1, start=2)[0])
    assert len(srv.engine.cache) == n


# ---------------------------------------------------------------------------
# tests/test_batching.py, the serving half
# ---------------------------------------------------------------------------

def test_server_query_batch_matches_jit(cats, ref):
    """Rows against ``jit``; the batch books against a fresh reference
    server's on the same batch: a device batch is one launch sequence in
    both, padded to its bucket shape."""
    srv = server(cats)
    res = srv.query_batch(MIXED_BATCH)
    for q, r in zip(MIXED_BATCH, res):
        assert_same(ref.query(q), r, q)
    rsrv = RSparqlServer(cats[0], backend="jit")
    rsrv.query_batch(MIXED_BATCH)
    m, rm = srv.metrics.summary(), rsrv.metrics.summary()
    assert m["batches"] >= 2 and m["batches"] == rm["batches"]
    assert m["padding_waste"] == rm["padding_waste"] > 0.0
    assert m["batch_occupancy"] == rm["batch_occupancy"]


def test_server_submit_flush_demux(cats, ref):
    srv = server(cats, max_batch=8, flush_ms=1e9)
    queries = _instances(5)
    tickets = [srv.submit(q) for q in queries]
    assert srv.batcher.pending() == 5 and not tickets[0].done()
    assert srv.flush() == 5 and srv.batcher.pending() == 0
    for q, t in zip(queries, tickets):
        assert t.done()
        assert_same(ref.query(q), t.result(), q)
    m = srv.metrics.summary()
    assert m["batches"] == 1 and m["batched_requests"] == 5
    assert srv.metrics.queue_hist.count == 5


def test_server_full_bucket_auto_flushes(cats):
    srv = server(cats, max_batch=4, flush_ms=1e9)
    tickets = [srv.submit(q) for q in _instances(4)]
    assert all(t.done() for t in tickets)
    assert srv.batcher.pending() == 0


def test_ticket_result_forces_own_group(cats):
    srv = server(cats, max_batch=32, flush_ms=1e9)
    t1 = srv.submit(_instances(1)[0])
    t2 = srv.submit("SELECT * WHERE { ?u wsdbm:likes ?p }")
    assert len(t2.result()) > 0
    assert not t1.done() and srv.batcher.pending() == 1
    assert len(t1.result()) >= 0
    assert srv.batcher.pending() == 0


def test_latency_flush_on_submit(cats):
    clock = FakeClock()
    srv = server(cats, max_batch=32, flush_ms=2.0,
                 runtime=RuntimeConfig(clock=clock))
    t1 = srv.submit(_instances(1)[0])
    clock.advance(0.001)
    srv.submit(_instances(1, start=2)[0])
    assert not t1.done()                 # 1 ms < flush_ms
    clock.advance(0.0015)
    srv.submit(_instances(1, start=3)[0])
    assert t1.done() and srv.batcher.pending() == 0
    # the queue waits are read on the same clock: 2.5, 1.5 and 0 ms
    q = srv.metrics.queue_hist
    assert (q.count, q.min_ms, q.max_ms) == (3, 0.0, 2.5)
    assert q.sum_ms == pytest.approx(4.0)


def test_full_bucket_does_not_starve_other_signatures(cats):
    srv = server(cats, max_batch=2, flush_ms=0.0)
    lone = srv.submit("SELECT * WHERE { ?u wsdbm:likes ?p }")
    srv.submit(_instances(1)[0])
    srv.submit(_instances(1, start=2)[0])
    assert lone.done()


def test_failed_batch_resolves_tickets_with_error(cats):
    srv = server(cats, max_batch=32, flush_ms=1e9)
    t1 = srv.submit(_instances(1)[0])
    t2 = srv.submit(_instances(1, start=2)[0])

    def boom(qtexts):
        raise RuntimeError("capacity overflow")
    srv.engine.query_batch = boom
    with pytest.raises(RuntimeError, match="capacity overflow"):
        srv.flush()
    assert t1.done() and t2.done()
    with pytest.raises(RuntimeError, match="capacity overflow"):
        t1.result()


def test_interleaved_suite_through_batcher_matches_jit(cats, ref):
    """Every basic template, instances interleaved, through submit and
    flush: each ticket equals the reference server's answer."""
    srv = server(cats, max_batch=4, flush_ms=1e9)
    qs = basic_queries(cats[2], seed=3, n_instances=5)
    order = [qs[n][i] for i in range(5) for n in qs]
    tickets = [srv.submit(q) for q in order]
    srv.flush()
    for q, t in zip(order, tickets):
        assert_same(ref.query(q), t.result(), q)
    m = srv.metrics.summary()
    assert m["served"] == len(order) and m["device_fallbacks"] == 0
    assert m["queue_p50_ms"] is not None


# ---------------------------------------------------------------------------
# Booting, devices, ranks
# ---------------------------------------------------------------------------

def test_boot_from_store_path(cats, ref, tmp_path):
    ds = Dataset(catalog=cats[1], device="cpu")
    ds.save(str(tmp_path / "store"))
    for eager in (False, True):
        srv = SparqlServer(str(tmp_path / "store"), device="cpu",
                           eager_load=eager)
        assert srv.dataset.store_path == str(tmp_path / "store")
        for q in MIXED_BATCH:
            assert_same(ref.query(q), srv.query(q), q)
        for q, r in zip(MIXED_BATCH, srv.query_batch(MIXED_BATCH)):
            assert_same(ref.query(q), r, q)


def test_server_needs_cuda_unless_asked_for_cpu(cats, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SparqlServer(cats[1])
    Dataset(catalog=cats[1], device="cpu").save(str(tmp_path / "s"))
    with pytest.raises(RuntimeError, match="CUDA"):
        SparqlServer(str(tmp_path / "s"))
    srv = SparqlServer(cats[1], device="cpu")
    assert srv.engine.device.type == "cpu"


def test_two_gloo_ranks_serve_through_the_batcher(tmp_path):
    """Each rank runs its own batcher over the same requests; with
    ``flush_ms=0`` a single-device batcher would drain every bucket on
    the next submit, but here only full buckets drain until the flush,
    so both ranks group the requests alike."""
    results = run_group("serve", 2, tmp_path, scale=0.1, max_batch=4,
                        instances=5)
    for r in results:
        # per template, one full bucket of 4 drained on submit and the
        # fifth request waited for the flush
        assert r["equal"] == 5 * r["templates"]
        assert r["pending"] == r["served"] == r["templates"]
        assert r["batches"] == 2 * r["templates"]
        assert r["fallbacks"] == 0
        assert r["launch_backends"] == ["distributed"]
        assert r["launch_shards"] == [2]
        assert r["with_cardinalities"] > 0
    assert results[0] == results[1]


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def _launch(*argv, cwd=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv],
        env=env, capture_output=True, text=True, timeout=300, cwd=cwd)


def _inspect(path, *flags):
    out = subprocess.run([sys.executable, str(ROOT / "tools" /
                                               "trace_inspect.py"),
                          str(path), *flags],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_launcher_on_cpu(tmp_path):
    store = tmp_path / "store"
    out = _launch("--device", "cpu", "--scale", "0.1", "--passes", "2",
                  "--store", str(store), "--trace-sample", "1.0",
                  "--trace-dump", str(tmp_path / "t.jsonl"),
                  "--metrics-out", str(tmp_path / "m.prom"),
                  "--runtime-report")
    assert out.returncode == 0, out.stderr
    assert "built and persisted store" in out.stdout
    assert f"served {2 * len(ST_QUERIES)} queries" in out.stdout
    report = json.loads(out.stdout[out.stdout.index("{\n"):
                                   out.stdout.index("\n}\n") + 2])
    assert report["backend"] == "torch"
    assert report["config"]["trace_sample_rate"] == 1.0
    prom = (tmp_path / "m.prom").read_text()
    assert "# TYPE repro_request_latency_ms histogram" in prom
    assert 'repro_stage_ms_bucket{stage="device.launch"' in prom
    table = _inspect(tmp_path / "t.jsonl")
    assert "torch" in table and "SELECT" in table
    assert "device.launch" in _inspect(tmp_path / "t.jsonl", "--stages")
    assert "est=" in _inspect(tmp_path / "t.jsonl", "--drift")

    # the second boot loads the store; the Chrome form reads back too
    out = _launch("--device", "cpu", "--store", str(store),
                  "--planner", "estimate", "--layout", "vp",
                  "--trace-sample", "0.5",
                  "--trace-dump", str(tmp_path / "t.json"))
    assert out.returncode == 0, out.stderr
    assert "cold start from store" in out.stdout
    assert f"wrote {len(ST_QUERIES) // 2} trace(s)" in out.stdout
    assert "device.launch" in _inspect(tmp_path / "t.json", "--stages")


def test_launcher_distributed_world_of_one_on_cpu(tmp_path):
    out = _launch("--device", "cpu", "--scale", "0.05",
                  "--backend", "distributed", "--trace-sample", "1.0",
                  "--metrics-out", str(tmp_path / "m.prom"))
    assert out.returncode == 0, out.stderr
    assert "on 1 shard(s), backend=distributed" in out.stdout
    assert 'repro_routed_total{backend="distributed"}' in \
        (tmp_path / "m.prom").read_text()


def test_launcher_needs_cuda_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _launch("--scale", "0.05")
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert "served" not in out.stdout


# ------------------------------------------- the port's own serving spans
# (no reference counterpart: the batcher's ``submit`` and ``flush``, the
# engine's ``front``, the executor's ``head_sync`` and ``copyback``, the
# ``queue`` wait off the span stack, and the profiler ranges they open)

class TickClock:
    """A clock that moves one microsecond at every reading, so spans
    opened one after the other never share an instant."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-6
        return self.t


@pytest.fixture(scope="module")
def scale1():
    return Dataset.watdiv(1.0, device="cpu")


def traced_server(ds, rate=1.0, **kw):
    kw.setdefault("flush_ms", 1e9)
    return SparqlServer(ds, device="cpu", runtime=RuntimeConfig(
        trace_sample_rate=rate, clock=TickClock()), **kw)


ALL_LIKES = "SELECT * WHERE { ?u wsdbm:likes ?p }"


def _edges(trace):
    """(span, its parent's name) of every span but the root."""
    by = {s.sid: s for s in trace.spans}
    return {(s.name, by[s.parent].name) for s in trace.spans[1:]}


def _one(trace, name):
    found = [s for s in trace.spans if s.name == name]
    assert len(found) == 1, (name, trace.spans)
    return found[0]


def _serve_scenario(srv):
    """A bucket of four that the fourth submit drains, one request that
    its own ``result()`` drains, and one whose submit drains it."""
    tickets = [srv.submit(q) for q in _instances(4)]
    assert all(t.done() for t in tickets)
    single = srv.submit(ALL_LIKES)
    assert not single.done()
    single.result()
    srv.batcher.max_batch = 1
    nested = srv.submit(ALL_LIKES)
    assert nested.done()
    return tickets, single, nested


def _mirrored(traces):
    """Range names a run's traces should have opened: one per span but
    the root, the queue wait and a chunk's shared executes, and one
    ``finish`` per finished trace."""
    from collections import Counter
    return Counter(s.name for tr in traces for s in tr.spans[1:]
                   if s.name != "queue" and
                   not s.attrs.get("shared_launch", False)) + \
        Counter(finish=sum(tr.root.t1 is not None for tr in traces))


def test_served_span_trees_nest_the_new_spans(scale1):
    srv = traced_server(scale1, max_batch=4)
    tickets, single, nested = _serve_scenario(srv)
    lead = tickets[0].trace
    assert _edges(lead) >= {
        ("submit", "request"), ("queue", "request"), ("flush", "request"),
        ("front", "flush"), ("parse", "front"), ("plan", "front"),
        ("execute", "flush"), ("device.launch", "execute"),
        ("head_sync", "device.launch"), ("copyback", "execute"),
        ("demux", "execute")}
    assert _one(lead, "flush").attrs["requests"] == 4
    assert _one(lead, "front").attrs["requests"] == 4
    # the others share the lead's launch: an execute under their own
    # open submit (the fourth drained the bucket) or under the root
    for t in tickets[1:]:
        names = {s.name for s in t.trace.spans}
        assert not names & {"flush", "front", "head_sync", "copyback"}
        assert _one(t.trace, "execute").attrs["shared_launch"] is True
    assert ("execute", "submit") in _edges(tickets[-1].trace)
    assert _edges(single.trace) >= {
        ("flush", "request"), ("front", "flush"), ("execute", "flush"),
        ("head_sync", "device.launch"), ("copyback", "execute")}
    assert _edges(nested.trace) >= {
        ("flush", "submit"), ("front", "flush"), ("execute", "flush"),
        ("head_sync", "device.launch"), ("copyback", "execute")}
    for tr in (lead, single.trace, nested.trace):
        front, ex = _one(tr, "front"), _one(tr, "execute")
        launches = [s for s in tr.spans if s.name == "device.launch"]
        copy, demux = _one(tr, "copyback"), _one(tr, "demux")
        assert front.t1 <= ex.t0
        assert max(s.t1 for s in launches) <= copy.t0
        assert copy.t1 <= demux.t0 <= demux.t1 <= ex.t1
        assert all(s.t1 is not None for s in tr.spans)


def test_batcher_spans_close_at_their_own_end(scale1, monkeypatch):
    """The batcher's bookkeeping after the engine returns runs inside
    ``flush``; a drain nested in ``submit`` runs inside it, and the
    trace finishes only after both have closed."""
    srv = traced_server(scale1, max_batch=4)
    clock = srv.engine.config.clock
    queued = []
    record = srv.engine.metrics.record_queue
    monkeypatch.setattr(srv.engine.metrics, "record_queue",
                        lambda ms: (queued.append(clock()), record(ms)))
    tickets, single, nested = _serve_scenario(srv)
    assert len(queued) == 6
    for tr, t in ((tickets[0].trace, queued[0]), (single.trace, queued[4]),
                  (nested.trace, queued[5])):
        flush, ex = _one(tr, "flush"), _one(tr, "execute")
        assert ex.t1 < t < flush.t1 < tr.root.t1
    submit = _one(nested.trace, "submit")
    assert _one(nested.trace, "flush").t1 < submit.t1 < nested.trace.root.t1
    assert srv.engine.tracer.finished == 6


def test_queue_survives_the_end_of_submit(scale1):
    srv = traced_server(scale1, max_batch=4)
    tickets = [srv.submit(q) for q in _instances(3)]
    lead = tickets[0].trace
    submit, queue = _one(lead, "submit"), _one(lead, "queue")
    assert submit.t1 is not None and queue.t1 is None
    tickets[0].result()
    flush, front = _one(lead, "flush"), _one(lead, "front")
    assert submit.t1 < flush.t0 <= queue.t1 <= front.t0
    assert queue.parent == 0 and queue.attrs["batch"] == 3


def test_copyback_bytes_are_the_returned_arrays(scale1, monkeypatch):
    from repro_torch.core import jexec
    returned = []
    launch = jexec.PlanExecutor._launch

    def spy(self, *args, **kwargs):
        out = launch(self, *args, **kwargs)
        returned.append(out)
        return out
    monkeypatch.setattr(jexec.PlanExecutor, "_launch", spy)
    tickets, single, nested = _serve_scenario(
        traced_server(scale1, max_batch=4))
    copies = [_one(t.trace, "copyback")
              for t in (tickets[0], single, nested)]
    assert len(returned) == 3
    assert [c.attrs["bytes"] for c in copies] == \
        [sum(a.nbytes for a, _ in out) for out in returned]
    assert [c.attrs["rows"] for c in copies] == \
        [sum(len(a) for a, _ in out) for out in returned]
    assert [c.attrs["bindings"] for c in copies] == [4, 1, 1]
    assert copies[1].attrs["bytes"] > 0


def test_profiler_holds_one_range_a_mirrored_span(scale1, tmp_path):
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile
    srv = traced_server(scale1, max_batch=4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tickets, single, nested = _serve_scenario(srv)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    ranges = Counter(e["name"][len("repro."):] for e in events
                     if e.get("cat") == "user_annotation"
                     and e.get("name", "").startswith("repro."))
    traces = [t.trace for t in tickets] + [single.trace, nested.trace]
    want = _mirrored(traces)
    assert ranges == want
    assert set(want) >= {"submit", "flush", "front", "execute",
                         "device.launch", "head_sync", "copyback", "demux"}


def test_profiler_off_enters_no_range(scale1, monkeypatch):
    entered = []
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        lambda *a: entered.append(a))
    _serve_scenario(traced_server(scale1, max_batch=4))
    assert entered == []


def test_every_range_closes_exactly_once(scale1, monkeypatch):
    """With the profiler on, a range a span opens is closed once, also
    where an enclosing ``end`` or ``finish`` closed the span early."""
    from collections import Counter
    from types import SimpleNamespace
    entered, exited = [], []

    def enter(name, args):
        entered.append(name)
        return len(entered)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        enter)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_exit",
                        SimpleNamespace(_RecordFunction=exited.append))
    tickets, single, nested = _serve_scenario(
        traced_server(scale1, max_batch=4))
    assert sorted(exited) == list(range(1, len(entered) + 1))
    traces = [t.trace for t in tickets] + [single.trace, nested.trace]
    assert Counter(n[len("repro."):] for n in entered) == _mirrored(traces)


def test_untraced_serving_builds_no_span(scale1, monkeypatch):
    from repro_torch.obs import tracer
    built = []

    class Counted(tracer.Span):
        __slots__ = ()

        def __init__(self, *args):
            built.append(args[1])
            super().__init__(*args)
    monkeypatch.setattr(tracer, "Span", Counted)
    srv = traced_server(scale1, rate=0.0, max_batch=4)
    tickets, single, nested = _serve_scenario(srv)
    assert built == []
    assert all(t.trace is None for t in (*tickets, single, nested))
    assert srv.engine.tracer.started == 0
