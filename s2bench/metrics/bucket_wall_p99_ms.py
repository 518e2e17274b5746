"""99th percentile, by nearest rank, of the buckets' wall times: the
``execute`` span of each bucket's lead request (serving front end)."""

import math

from s2bench.spans import bucket_readings


def read(run):
    walls = sorted(b["wall_ms"] for b in bucket_readings(run.requests))
    if not walls:
        return None
    return walls[max(0, math.ceil(0.99 * len(walls)) - 1)]
