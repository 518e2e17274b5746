"""Mean over buckets of the lead's ``execute`` span less its
``device.launch`` spans: staging the bindings' inputs, the copy of every
binding's rows back to the host (``PlanExecutor._launch``), and the
``demux`` into per-request results (``engine/backends.py``,
``engine/result.py``)."""

from s2bench.spans import bucket_readings


def read(run):
    buckets = bucket_readings(run.requests)
    if not buckets:
        return None
    return sum(b["copyback_ms"] for b in buckets) / len(buckets)
