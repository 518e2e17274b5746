"""The readers of the program's ``front``, ``head_sync`` and ``copyback``
spans and of the device trace's idle gaps, on synthetic runs; and the
bucket readings of a trace the port's server records (scale 1, CPU)."""

from types import SimpleNamespace as NS

import pytest

from s2bench import spec
from s2bench.devtrace import TOP
from s2bench.spans import bucket_readings

NEW = ("front_span_ms_per_request", "launch_sync_ms_per_bucket",
       "copyback_gbps")


def read(name, run):
    return spec.metric_reader(name).read(run)


def span(sid, name, parent, t0, t1, **attrs):
    return NS(sid=sid, name=name, parent=parent, t0=t0, t1=t1, attrs=attrs)


def req(*spans, group=1):
    return NS(trace=NS(spans=list(spans)), group=group)


# a bucket of two in two attempts: the lead's trace, then the other's
LEAD = req(span(0, "request", None, 0.000, 0.100),
           span(1, "submit", 0, 0.000, 0.001),
           span(2, "queue", 0, 0.000, 0.009, batch=2),
           span(3, "flush", 0, 0.009, 0.090, requests=2),
           span(4, "front", 3, 0.009, 0.012, requests=2),
           span(5, "execute", 3, 0.012, 0.080, shared_launch=False,
                batch=2),
           span(6, "device.launch", 5, 0.013, 0.030),
           span(7, "head_sync", 6, 0.025, 0.030),
           span(8, "device.launch", 5, 0.031, 0.060),
           span(9, "head_sync", 8, 0.050, 0.060),
           span(10, "copyback", 5, 0.060, 0.070, bytes=4_000_000,
                rows=500_000, bindings=2),
           span(11, "demux", 5, 0.070, 0.080))
OTHER = req(span(0, "request", None, 0.001, 0.100),
            span(1, "submit", 0, 0.001, 0.002),
            span(2, "queue", 0, 0.001, 0.009, batch=2),
            span(3, "execute", 0, 0.012, 0.080, shared_launch=True,
                 batch=2))
# a bucket of one, a plan-cache miss inside its front end
SINGLE = req(span(0, "request", None, 0.200, 0.300),
             span(1, "submit", 0, 0.200, 0.230),
             span(2, "queue", 0, 0.200, 0.201, batch=1),
             span(3, "flush", 1, 0.201, 0.230, requests=1),
             span(4, "front", 3, 0.201, 0.205, requests=1),
             span(5, "parse", 4, 0.202, 0.203),
             span(6, "execute", 3, 0.205, 0.225, shared_launch=False,
                  batch=1),
             span(7, "device.launch", 6, 0.205, 0.215),
             span(8, "head_sync", 7, 0.210, 0.215),
             span(9, "copyback", 6, 0.215, 0.216, bytes=1_000_000,
                  rows=125_000, bindings=1),
             span(10, "demux", 6, 0.216, 0.225),
             group=2)
UNTRACED = NS(trace=None, group=3)


def _parent_shaped(r):
    """The same request as the parent program traces it: no ``submit``,
    ``flush``, ``front``, ``head_sync`` or ``copyback``."""
    return NS(group=r.group, trace=NS(spans=[
        s for s in r.trace.spans if s.name not in
        ("submit", "flush", "front", "head_sync", "copyback")]))


def test_front_span_ms_per_request():
    run = NS(requests=[LEAD, OTHER, SINGLE, UNTRACED])
    # (3 ms + 4 ms) over 2 + 1 requests
    assert read("front_span_ms_per_request", run) == pytest.approx(7 / 3)


def test_launch_sync_ms_per_bucket():
    run = NS(requests=[LEAD, OTHER, SINGLE, UNTRACED])
    # (5 + 10 ms) and 5 ms over two buckets
    assert read("launch_sync_ms_per_bucket", run) == pytest.approx(10.0)


def test_copyback_gbps():
    run = NS(requests=[LEAD, OTHER, SINGLE, UNTRACED])
    # 5 MB in 11 ms
    assert read("copyback_gbps", run) == pytest.approx(5e6 / 0.011 / 1e9)


@pytest.mark.parametrize("name", NEW)
def test_span_readers_read_nothing_from_the_parent(name):
    run = NS(requests=[_parent_shaped(LEAD), _parent_shaped(OTHER),
                       _parent_shaped(SINGLE), UNTRACED])
    assert read(name, run) is None
    assert read(name, NS(requests=[])) is None


def _profile(gaps):
    return {"busy_s": 1.0, "window_s": 3.0,
            "breakdown": {"device_ops": [], "idle_gaps": gaps}}


def test_idle_outside_program_share():
    name = "idle_outside_program_share"
    gaps = [["repro.device.launch", 0.9], ["repro.copyback", 0.3],
            ["no host event", 0.15], ["cudaLaunchKernel", 0.1]]
    assert read(name, NS(profile=_profile(gaps))) == pytest.approx(5.0)
    # fewer entries than the breakdown keeps: there was no such gap
    assert read(name, NS(profile=_profile(gaps[:2]))) == 0.0
    # a full list without it: the last entry's seconds bound it
    full = [[f"repro.s{i}", 0.3 - 0.03 * i] for i in range(TOP)]
    assert read(name, NS(profile=_profile(full))) == \
        pytest.approx(100 * full[-1][1] / 3.0)
    assert read(name, NS(profile=None)) is None


def test_bucket_readings_keep_their_fields_and_counts():
    want = {"wall_ms", "launch_ms", "attempts", "copyback_ms", "front_ms",
            "size"}
    requests = [LEAD, OTHER, SINGLE, UNTRACED]
    got = bucket_readings(requests)
    parent = bucket_readings([_parent_shaped(r) if r.trace else r
                              for r in requests])
    assert len(got) == len(parent) == 2
    for g, p in zip(got, parent):
        assert set(g) == set(p) == want
        assert g == pytest.approx(p)
    assert got[0] == pytest.approx({
        "wall_ms": 68.0, "launch_ms": 46.0, "attempts": 2.0,
        "copyback_ms": 22.0, "front_ms": 3.0, "size": 2.0})
    # a plan-cache miss adds its parse span to the inferred front end
    assert got[1]["front_ms"] == pytest.approx(4.0 + 1.0)


def test_served_traces_read():
    """A scale-1 server traced at rate 1.0: one bucket reading a flush
    group, and every new reader finds its spans."""
    from repro_torch import Dataset, RuntimeConfig, SparqlServer
    srv = SparqlServer(Dataset.watdiv(1.0, device="cpu"), device="cpu",
                       max_batch=4, flush_ms=1e9,
                       runtime=RuntimeConfig(trace_sample_rate=1.0))
    texts = [f"SELECT * WHERE {{ wsdbm:User{u} wsdbm:follows ?v . "
             f"?v sorg:email ?e }}" for u in range(1, 5)]
    groups = [[srv.submit(q) for q in texts],
              [srv.submit("SELECT * WHERE { ?u wsdbm:likes ?p }")]]
    groups[1][0].result()
    requests = [NS(trace=t.trace, group=g) for g, ts in enumerate(groups)
                for t in ts]
    buckets = bucket_readings(requests)
    assert [b["size"] for b in buckets] == [4.0, 1.0]
    assert [b["attempts"] for b in buckets] == [1.0, 1.0]
    run = NS(requests=requests)
    for name in NEW:
        assert read(name, run) > 0, name
    launch = sum(b["launch_ms"] for b in buckets) / len(buckets)
    assert read("launch_sync_ms_per_bucket", run) <= launch
