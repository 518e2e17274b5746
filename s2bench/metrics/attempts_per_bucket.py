"""Mean over buckets of the ``device.launch`` spans a bucket opened: 1
when its caps held, one more for every overflow retry (executor:
``core/jexec.py``)."""

from s2bench.spans import bucket_readings


def read(run):
    buckets = bucket_readings(run.requests)
    if not buckets:
        return None
    return sum(b["attempts"] for b in buckets) / len(buckets)
