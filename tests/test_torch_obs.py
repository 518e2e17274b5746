"""The port's observability layer (``repro_torch.obs``, ``ServerMetrics``)
against the JAX package's, case for case with ``tests/test_obs.py``:
every scenario runs on both packages' objects under the same injected
fake clock, and the outputs must be equal — percentiles and bucket
series, stride picks, Chrome traces, JSONL and Prometheus text, byte
for byte — besides holding the reference test's own property.  The
engine cases run the port's engine beside the reference's ``jit``
engine over the same catalog: launch spans carry the same estimated
and actual per-step cardinalities, traced results equal untraced ones,
batcher queue spans, and the Prometheus page end to end."""

import json

import numpy as np
import pytest

from repro.engine import Dataset as RDataset
from repro.engine import RuntimeConfig as RRuntimeConfig
from repro.engine import ServerMetrics as RServerMetrics
from repro.obs import FlightRecorder as RFlightRecorder
from repro.obs import LogHistogram as RLogHistogram
from repro.obs import TraceContext as RTraceContext
from repro.obs import Tracer as RTracer

from repro_torch import Dataset, RuntimeConfig, ServerMetrics
from repro_torch.obs import FlightRecorder, LogHistogram, TraceContext, Tracer
from repro_torch.obs.histogram import GROWTH
from repro_torch.serve.batcher import MicroBatcher

from test_torch_data import port_catalog

PORT = {"LogHistogram": LogHistogram, "Tracer": Tracer,
        "TraceContext": TraceContext, "FlightRecorder": FlightRecorder,
        "RuntimeConfig": RuntimeConfig, "ServerMetrics": ServerMetrics}
REF = {"LogHistogram": RLogHistogram, "Tracer": RTracer,
       "TraceContext": RTraceContext, "FlightRecorder": RFlightRecorder,
       # both packages' plan verifiers follow REPRO_RT_VERIFY_PLANS, so
       # their "verify" spans and stage histograms are compared too
       "RuntimeConfig": RRuntimeConfig,
       "ServerMetrics": RServerMetrics}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, seconds):
        self.t += seconds


def both(scenario):
    """``scenario(ns)`` on the port's classes and on the reference's;
    the two outputs must be equal.  Returns the port's."""
    got, want = scenario(PORT), scenario(REF)
    assert got == want
    return got


def _tracer(ns, **kw):
    kw.setdefault("clock", FakeClock())
    kw.setdefault("trace_sample_rate", 1.0)
    return ns["Tracer"](ns["RuntimeConfig"](**kw))


# ---------------------------------------------------------------- histogram

def _hist_of(ns, samples):
    h = ns["LogHistogram"]()
    for s in samples:
        h.record(float(s))
    return h


def _hist_view(h):
    return (h.count, h.sum_ms, h.min_ms, h.max_ms,
            [h.percentile(q) for q in (0, 1, 25, 50, 90, 99, 99.9, 100)],
            list(h.cumulative_buckets()))


class TestLogHistogram:
    def test_empty_is_none_not_zero(self):
        def run(ns):
            h = ns["LogHistogram"]()
            return h.percentile(50), h.percentile(99), h.mean_ms, len(h)
        assert both(run) == (None, None, None, 0)

    def test_single_sample_reports_itself(self):
        def run(ns):
            h = _hist_of(ns, [3.7])
            return h.percentile(50), h.percentile(99)
        p50, p99 = both(run)
        assert p50 == pytest.approx(3.7) and p99 == pytest.approx(3.7)

    def test_percentile_error_bound(self):
        rng = np.random.default_rng(0)
        samples = np.exp(rng.normal(1.0, 1.5, size=2000))
        view = both(lambda ns: _hist_view(_hist_of(ns, samples)))
        ordered = np.sort(samples)
        for q, got in zip((0, 1, 25, 50, 90, 99, 99.9, 100), view[4]):
            rank = max(1, int(np.ceil(q / 100.0 * len(ordered))))
            exact = ordered[rank - 1]
            assert exact <= got <= exact * GROWTH * (1 + 1e-12)

    def test_out_of_range_samples_clamped_to_observed(self):
        def run(ns):
            return (_hist_of(ns, [1e-9]).percentile(50),
                    _hist_of(ns, [1e9]).percentile(99))
        lo, hi = both(run)
        assert lo == pytest.approx(1e-9) and hi == pytest.approx(1e9)

    def test_merge_equals_combined_recording(self):
        rng = np.random.default_rng(1)
        a_samples = rng.exponential(5.0, 300)
        b_samples = rng.exponential(50.0, 300)

        def run(ns):
            a = _hist_of(ns, a_samples)
            a.merge(_hist_of(ns, b_samples))
            return _hist_view(a), _hist_view(
                _hist_of(ns, list(a_samples) + list(b_samples)))
        merged, combined = both(run)
        assert merged[0] == combined[0] and merged[4] == combined[4]

    def test_record_large_count_is_o1(self):
        def run(ns):
            h = ns["LogHistogram"]()
            h.record(2.0, count=10**9)
            return h.count, h.percentile(99)
        assert both(run) == (10**9, pytest.approx(2.0))

    def test_cumulative_buckets_monotone_and_total(self):
        def run(ns):
            return list(_hist_of(ns, (0.01, 0.5, 0.5, 7.0, 300.0))
                        .cumulative_buckets())
        pairs = both(run)
        edges, cums = [e for e, _ in pairs], [c for _, c in pairs]
        assert edges == sorted(edges)
        assert cums == sorted(cums) and cums[-1] == 5

    def test_invalid_percentile(self):
        for ns in (PORT, REF):
            h = _hist_of(ns, [1.0])
            with pytest.raises(ValueError):
                h.percentile(101)


# ------------------------------------------------------------------ sampling

class TestSampling:
    def test_rate_zero_inactive(self):
        def run(ns):
            tr = _tracer(ns, trace_sample_rate=0.0)
            return tr.active, tr.begin("q")
        assert both(run) == (False, None)

    @pytest.mark.parametrize("rate", [1.0, 0.5, 0.25, 0.1, 0.3])
    def test_stride_sampling_deterministic(self, rate):
        def run(ns):
            tr = _tracer(ns, trace_sample_rate=rate)
            picks = [tr.begin("q") is not None for _ in range(20)]
            return picks, tr.started, tr.sampled_out
        picks, started, out = both(run)
        assert started == sum(picks) and started + out == 20

    def test_sampled_out_leaves_zero_records(self):
        def run(ns):
            tr = _tracer(ns, trace_sample_rate=0.25)
            for _ in range(8):
                ctx = tr.begin("q")
                if ctx is not None:
                    ctx.finish()
            return tr.started, tr.sampled_out, len(tr.recorder)
        assert both(run) == (2, 6, 2)

    def test_rate_is_read_live_from_config(self):
        def run(ns):
            tr = _tracer(ns, trace_sample_rate=1.0)
            first = tr.begin("q") is not None
            tr.config.trace_sample_rate = 0.0
            return first, tr.active, tr.begin("q")
        assert both(run) == (True, False, None)

    def test_invalid_rate_rejected(self):
        for ns in (PORT, REF):
            for bad in (1.5, -0.1):
                with pytest.raises(ValueError):
                    ns["RuntimeConfig"](trace_sample_rate=bad)


# -------------------------------------------------------------------- spans

def _exports(tr):
    return json.dumps(tr.chrome_trace(), sort_keys=True), tr.to_jsonl()


class TestSpanNesting:
    def test_nesting_and_ordering(self):
        def run(ns):
            tr = _tracer(ns)
            clock = tr.config.clock
            ctx = tr.begin("q")
            clock.advance(0.001)
            a = ctx.start("plan")
            clock.advance(0.002)
            b = ctx.start("verify")
            clock.advance(0.003)
            ctx.end(b)
            clock.advance(0.001)
            ctx.end(a)
            clock.advance(0.001)
            c = ctx.start("execute")
            clock.advance(0.005)
            ctx.end(c)
            ctx.finish()
            spans = [(s.sid, s.name, s.parent, s.t0, s.t1) for s in ctx.spans]
            return spans, ctx.duration_ms, _exports(tr)
        spans, dur, _ = both(run)
        assert [s[2] for s in spans] == [None, 0, 1, 0]
        assert dur == pytest.approx(13.0)

    def test_dangling_child_closed_by_parent_end(self):
        def run(ns):
            tr = _tracer(ns)
            ctx = tr.begin("q")
            outer = ctx.start("outer")
            inner = ctx.start("inner")
            tr.config.clock.advance(0.004)
            ctx.end(outer)
            ctx.finish()
            return ctx.spans[inner].t1 == ctx.spans[outer].t1, _exports(tr)
        assert both(run)[0]

    def test_finish_idempotent_and_closes_stragglers(self):
        def run(ns):
            tr = _tracer(ns)
            ctx = tr.begin("q")
            ctx.start("open-span")
            tr.config.clock.advance(0.010)
            ctx.finish(backend="torch")
            ctx.finish()
            return (tr.finished, all(s.t1 is not None for s in ctx.spans),
                    ctx.root.attrs["backend"], _exports(tr))
        assert both(run)[:3] == (1, True, "torch")

    def test_events_attach_to_innermost_open_span(self):
        def run(ns):
            tr = _tracer(ns)
            ctx = tr.begin("q")
            sid = ctx.start("plan")
            ctx.event("plan_cache", hit=False)
            ctx.end(sid)
            ctx.event("root-level")
            return (ctx.spans[sid].events[0]["name"],
                    ctx.root.events[0]["name"])
        assert both(run) == ("plan_cache", "root-level")

    def test_annotate_named(self):
        def run(ns):
            ctx = _tracer(ns).begin("q")
            for _ in range(2):
                ctx.end(ctx.start("device.launch"))
            return (ctx.annotate_named("device.launch", cardinalities=[1]),
                    ctx.annotate_named("no-such-span", x=1))
        assert both(run) == (2, 0)


# ----------------------------------------------------------- flight recorder

def _fake_trace(ns, clock, trace_id, duration_s):
    ctx = ns["TraceContext"](trace_id, clock, None)
    clock.advance(duration_s)
    ctx.finish()
    return ctx


class TestFlightRecorder:
    def test_ring_evicts_but_slow_reservoir_keeps(self):
        def run(ns):
            clock = FakeClock()
            rec = ns["FlightRecorder"](ring=4, slow_ms=10.0, slow_keep=2)
            rec.add(_fake_trace(ns, clock, 1, 0.050))
            for i in range(10):
                rec.add(_fake_trace(ns, clock, 10 + i, 0.001))
            return ([c.trace_id for c in rec.traces()], rec.dropped,
                    rec.to_jsonl(), json.dumps(rec.chrome_trace()))
        ids, dropped, _, _ = both(run)
        assert 1 in ids and len([i for i in ids if i >= 10]) == 4
        assert dropped > 0

    def test_slow_reservoir_keeps_slowest(self):
        def run(ns):
            clock = FakeClock()
            rec = ns["FlightRecorder"](ring=1, slow_ms=10.0, slow_keep=2)
            for tid, dur in ((1, 0.020), (2, 0.040), (3, 0.030)):
                rec.add(_fake_trace(ns, clock, tid, dur))
            return sorted(c.trace_id for c in rec.traces())
        assert both(run) == [2, 3]

    def test_chrome_trace_round_trip(self):
        def run(ns):
            tr = _tracer(ns)
            clock = tr.config.clock
            for _ in range(3):
                ctx = tr.begin("SELECT * WHERE { ?s ?p ?o }")
                sid = ctx.start("plan", planner="greedy")
                clock.advance(0.002)
                ctx.end(sid)
                inner = ctx.start("execute")
                clock.advance(0.004)
                ctx.end(inner, rows=np.int64(7))   # numpy attr degrades
                ctx.finish()
            return json.dumps(tr.chrome_trace())
        doc = json.loads(both(run))
        assert doc["displayTimeUnit"] == "ms"
        spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        assert len({e["tid"] for e in spans}) == 3
        rows = next(e["args"]["rows"] for e in spans
                    if e["name"] == "execute")
        assert rows == 7 and isinstance(rows, int)

    def test_jsonl_round_trip(self):
        def run(ns):
            tr = _tracer(ns)
            ctx = tr.begin("q")
            tr.config.clock.advance(0.2)
            ctx.finish()
            return tr.to_jsonl()
        rows = [json.loads(line) for line in both(run).splitlines()]
        assert len(rows) == 1 and rows[0]["slow"] is True
        assert rows[0]["spans"][0]["name"] == "request"


# ------------------------------------------------------------ server metrics

class TestServerMetrics:
    def test_idle_percentiles_are_none(self):
        s = both(lambda ns: ns["ServerMetrics"]().summary())
        assert s["p50_ms"] is None and s["queue_p99_ms"] is None

    def test_latency_and_queue_histograms(self):
        def run(ns):
            m = ns["ServerMetrics"]()
            m.record_latency(5.0)
            m.record_latency(2.0, count=3)
            m.record_queue(1.5)
            return (_hist_view(m.latency_hist), _hist_view(m.queue_hist),
                    m.summary())
        lat, queue, summary = both(run)
        assert lat[0] == 4 and queue[0] == 1
        assert summary["p50_ms"] == pytest.approx(2.0, rel=GROWTH)
        assert summary["queue_p50_ms"] == pytest.approx(1.5)

    def test_record_flood_is_o1(self):
        def run(ns):
            m = ns["ServerMetrics"]()
            m.record_latency(1.0, count=10**9)
            return m.latency_hist.count, m.summary()["p99_ms"]
        assert both(run) == (10**9, pytest.approx(1.0))

    def test_prometheus_exposition(self):
        def run(ns):
            m = ns["ServerMetrics"]()
            m.served = 3
            m.record_latency(4.0)
            m.record_latency(0.25, count=5)
            m.record_queue(1.5)
            m.record_route("torch", 3)
            m.tracer = _tracer(ns)
            ctx = m.tracer.begin("q")
            m.tracer.config.clock.advance(0.003)
            ctx.end(ctx.start("device.launch"))
            ctx.finish()
            return m.prometheus()
        text = both(run)
        assert "repro_served_total 3" in text
        assert 'repro_routed_total{backend="torch"} 3' in text
        assert 'repro_request_latency_ms_bucket{le="+Inf"} 6' in text
        assert 'repro_stage_ms_bucket{stage="device.launch"' in text


# -------------------------------------------------------- engine integration

QA = "SELECT * WHERE { ?v0 <wsdbm:follows> ?v1 . ?v1 <wsdbm:likes> ?v2 }"
QB = "SELECT * WHERE { ?v0 <rev:reviewer> ?v1 . ?v1 <wsdbm:likes> ?v2 }"
QU = ["SELECT * WHERE { wsdbm:User%d wsdbm:follows ?v . ?v sorg:email ?e }"
      % u for u in (1, 2, 3, 4)]


@pytest.fixture(scope="module")
def pair(watdiv_small):
    cat, d, sch = watdiv_small
    rds = RDataset(catalog=cat, dictionary=d, schema=sch)
    return rds, Dataset(catalog=port_catalog(cat), device="cpu")


def _launch_spans(tracer):
    return [e for e in tracer.chrome_trace()["traceEvents"]
            if e.get("ph") == "X" and e["name"] == "device.launch"]


def _normalized(tracer):
    """JSONL trace dicts with the backend names unified (the router's
    events included)."""
    text = tracer.to_jsonl().replace('"jit"', '"torch"')
    return [json.loads(line) for line in text.splitlines()]


def _engines(pair, **kw):
    rds, ds = pair
    ref = rds.engine("jit", runtime=REF["RuntimeConfig"](**kw))
    port = ds.engine(runtime=RuntimeConfig(**kw))
    return ref, port


class TestEngineTracing:
    def test_trace_carries_cardinalities(self, pair):
        ref, eng = _engines(pair, trace_sample_rate=1.0, clock=FakeClock())
        for e in (ref, eng):
            e.query(QA)
            e.query(QA)       # second pass: plan-cache hit
            e.query(QB)
        assert eng.metrics.device_fallbacks == 0
        launches = _launch_spans(eng.tracer)
        want = _launch_spans(ref.tracer)
        assert launches and len(launches) == len(want)
        for e, w in zip(launches, want):
            assert e["args"]["backend"] == "torch"
            assert e["args"]["cardinalities"] == w["args"]["cardinalities"]
            for step in e["args"]["cardinalities"]:
                assert step["actual"] is not None
        events = [ev for tr in eng.tracer.recorder.traces()
                  for s in tr.spans for ev in s.events]
        outcomes = [ev["attrs"]["outcome"] for ev in events
                    if ev["name"] == "plan_cache"]
        assert outcomes == ["miss", "hit", "miss"]
        # under the injected clock the whole trace stream is the
        # reference's, span for span and attribute for attribute
        assert _normalized(eng.tracer) == _normalized(ref.tracer)

    def test_untraced_engine_records_nothing(self, pair):
        _, eng = _engines(pair)
        assert eng.query(QA) is not None
        assert eng.tracer.started == 0 and len(eng.tracer.recorder) == 0

    def test_traced_matches_untraced_results(self, pair):
        rds, ds = pair
        plain = ds.engine(runtime=RuntimeConfig())
        traced = ds.engine(runtime=RuntimeConfig(trace_sample_rate=1.0))
        ref = rds.engine("jit")
        for q in (QA, QB, *QU):
            a, b, r = plain.query(q), traced.query(q), ref.query(q)
            assert a.cols == b.cols == r.cols
            np.testing.assert_array_equal(a.data, b.data)
            np.testing.assert_array_equal(a.data, r.data)
        batched = traced.query_batch(QU + [QA])
        for q, got in zip(QU + [QA], batched):
            np.testing.assert_array_equal(got.data, plain.query(q).data)

    def test_batcher_queue_spans(self, pair):
        from repro.serve.batcher import MicroBatcher as RMicroBatcher
        ref, eng = _engines(pair, trace_sample_rate=1.0, clock=FakeClock())
        for cls, e in ((MicroBatcher, eng), (RMicroBatcher, ref)):
            mb = cls(e, max_batch=8, flush_ms=1e9)
            tickets = [mb.submit(QA) for _ in range(4)]
            mb.flush()
            assert all(t.result() is not None for t in tickets)
        ct = eng.tracer.chrome_trace()
        queues = [e for e in ct["traceEvents"]
                  if e.get("ph") == "X" and e["name"] == "queue"]
        assert len(queues) == 4
        assert all(e["args"]["batch"] == 4 for e in queues)
        execs = [e for e in ct["traceEvents"]
                 if e.get("ph") == "X" and e["name"] == "execute"]
        shared = [e["args"].get("shared_launch") for e in execs]
        assert shared.count(False) == 1 and shared.count(True) == 3
        # a batch of 4 is one of the reference's static shapes, so it
        # pads nothing and the two trace streams agree throughout
        assert _normalized(eng.tracer) == _normalized(ref.tracer)

    def test_prometheus_end_to_end(self, pair):
        ref, eng = _engines(pair, trace_sample_rate=1.0, clock=FakeClock())
        for e in (ref, eng):
            e.query(QA)
            e.query(QB)
            e.query_batch(QU)
            e.query(QU[0])
        text = eng.metrics.prometheus()
        assert "repro_served_total 7" in text
        assert 'repro_traces_total{state="finished"} 7' in text
        assert 'repro_stage_ms_bucket{stage="device.launch"' in text
        assert "repro_router_requests{sig=" in text
        assert 'repro_tuner_shape_active{shape="32"} 1' in text
        # the whole page, router and tuner families included
        assert text == ref.metrics.prometheus().replace('"jit"', '"torch"')
