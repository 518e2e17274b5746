"""Requests a bucket over the window: ``ServerMetrics.batched_requests``
over ``ServerMetrics.batches``, both counted from the window's start to
its end (serving front end: ``serve/batcher.py``, ``serve/engine.py``)."""


def read(run):
    c = run.counters
    if not c["batches"]:
        return None
    return c["batched_requests"] / c["batches"]
