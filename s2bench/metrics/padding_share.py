"""Share of launched batch slots that were padding, over the window:
``padding_slots / (batched_requests + padding_slots)`` of
``ServerMetrics`` (adaptive runtime: ``runtime/tuner.py`` picks the
shape a bucket is padded to)."""


def read(run):
    c = run.counters
    slots = c["batched_requests"] + c["padding_slots"]
    if not slots:
        return None
    return 100.0 * c["padding_slots"] / slots
