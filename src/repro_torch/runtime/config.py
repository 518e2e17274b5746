"""Runtime knobs of the serving layer.

Every knob the port's engine, tracer and micro-batcher read lives here,
with the reference's names, defaults and ``REPRO_RT_*`` environment
variables: one object, defaults readable in one place, every knob
overridable from the environment so a deployment can be re-tuned
without touching code.

The config also owns the **clock**: request latencies, span times and
the micro-batcher's queue waits are all measured through
``config.clock``, so injecting a fake clock makes traces, histograms
and the Prometheus text deterministic.

    cfg = RuntimeConfig(trace_sample_rate=0.1, flush_ms=5.0)
    eng = dataset.engine(runtime=cfg)

    REPRO_RT_TRACE_SAMPLE=1.0 python -m repro_torch.launch.serve ...

Knobs of the reference's backend router, batch-shape tuner and plan
verifier are not here: the port has none of those yet.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict

__all__ = ["RuntimeConfig", "runtime_config"]


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _env_float(name: str, default: float) -> float:
    return float(os.environ.get(name, default))


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in ("", "0", "false", "no", "off")


class RuntimeConfig:
    """The serving layer's knobs, with ``REPRO_RT_*`` env overrides.

    Keyword arguments override both the defaults and the environment;
    unknown names raise (typos must not silently become dead knobs).
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 **overrides):
        ######## Query planner ########
        # join-order planner: "greedy" is the paper's Algorithm 4
        # (#bound values, table size); "estimate" enumerates orders by
        # estimated intermediate cardinality (repro_torch.core.estimate)
        # and falls back to greedy on catalogs without distinct-count
        # statistics.  Part of the Engine's plan-cache key, so flipping
        # it mid-session re-plans instead of serving a stale order.
        self.planner = _env_str("REPRO_RT_PLANNER", "greedy")

        ######## Observability ########
        # fraction of requests that carry a full span trace
        # (repro_torch.obs): 0.0 disables tracing entirely (the engine's
        # guard-first fast path), 1.0 traces everything; in between is
        # deterministic stride sampling (1 in round(1/rate) requests)
        self.trace_sample_rate = _env_float("REPRO_RT_TRACE_SAMPLE", 0.0)
        # flight-recorder ring: newest N complete traces kept in memory
        self.trace_ring = _env_int("REPRO_RT_TRACE_RING", 256)
        # traces slower than this end-to-end survive ring eviction in the
        # slow-query reservoir (up to trace_slow_keep, slowest win)
        self.trace_slow_ms = _env_float("REPRO_RT_TRACE_SLOW_MS", 100.0)
        self.trace_slow_keep = _env_int("REPRO_RT_TRACE_SLOW_KEEP", 64)
        # join estimated vs. actual per-step cardinalities onto each
        # traced request's device-launch spans (the explain() drift
        # report as a sampled artifact); cached per (template, binding),
        # computed on the host — disable if even sampled requests must
        # never run host joins
        self.trace_cardinality = _env_bool("REPRO_RT_TRACE_CARDINALITY",
                                           True)

        ######## Micro-batching ########
        # largest bucket the micro-batcher lets fill, and how long the
        # oldest queued request may wait for batch-mates (checked on
        # every submit; not on the distributed backend, see
        # repro_torch.serve.batcher)
        self.max_batch = _env_int("REPRO_RT_MAX_BATCH", 32)
        self.flush_ms = _env_float("REPRO_RT_FLUSH_MS", 2.0)

        # injectable time source (seconds); every latency the engine,
        # tracer and batcher record is measured through this
        self.clock = clock

        for name, value in overrides.items():
            if not hasattr(self, name):
                raise ValueError(f"unknown RuntimeConfig knob {name!r}")
            setattr(self, name, value)
        if not 0.0 <= float(self.trace_sample_rate) <= 1.0:
            raise ValueError(
                f"trace_sample_rate must be in [0, 1], got "
                f"{self.trace_sample_rate!r}")
        if self.planner not in ("greedy", "estimate"):
            raise ValueError(
                f"planner must be 'greedy' or 'estimate', "
                f"got {self.planner!r}")
        if int(self.max_batch) < 1:
            raise ValueError(f"max_batch must be >= 1, got "
                             f"{self.max_batch!r}")

    def snapshot(self) -> Dict[str, object]:
        """JSON-friendly view of every knob (for ``runtime_report()``)."""
        return {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in vars(self).items() if k != "clock"}


#: Process-wide default instance.  Engines constructed without an
#: explicit ``runtime=`` share it.
runtime_config = RuntimeConfig()
