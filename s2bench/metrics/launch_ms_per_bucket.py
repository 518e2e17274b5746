"""Mean over buckets of the ``device.launch`` spans' time: the launch
sequence of each attempt up to the sync on its head of row counts
(executor: ``core/jexec.py``)."""

from s2bench.spans import bucket_readings


def read(run):
    buckets = bucket_readings(run.requests)
    if not buckets:
        return None
    return sum(b["launch_ms"] for b in buckets) / len(buckets)
