"""Seconds of the warm-up on the harness's clock: one full bucket of
every template of the mix through ``Engine.query_batch`` (plans, table
uploads, kernel loads, capacity growth, the allocator)."""


def read(run):
    return run.warmup_s
