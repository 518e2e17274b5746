"""Host time of the engine's front end a request (``engine/engine.py``,
``engine/template.py``, ``core/sparql.py``, ``core/compiler.py``): per
bucket the gap from the lead's ``queue`` span to its ``execute`` span
(signature grouping, plan-cache lookup, routing, constant binding) and
any ``parse``, ``plan`` and ``verify`` spans, summed and divided by the
requests of those buckets."""

from s2bench.spans import bucket_readings


def read(run):
    buckets = bucket_readings(run.requests)
    n = sum(b["size"] for b in buckets)
    if not n:
        return None
    return sum(b["front_ms"] for b in buckets) / n
