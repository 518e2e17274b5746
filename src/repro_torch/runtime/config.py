"""Runtime knobs of the serving layer and the adaptive runtime.

Every tunable of the :class:`~repro_torch.runtime.router.BackendRouter`,
the :class:`~repro_torch.runtime.tuner.BatchTuner`, the tracer and the
micro-batcher lives here, with the reference's names, defaults and
``REPRO_RT_*`` environment variables: one object, defaults readable in
one place, every knob overridable from the environment so a deployment
can be re-tuned without touching code.

The config also owns the **clock**: request latencies, span times, the
micro-batcher's queue waits and every latency the router and tuner see
are measured through ``config.clock``, so injecting a fake clock makes
routing decisions, traces, histograms and the Prometheus text
deterministic.

    cfg = RuntimeConfig(router_warmup=3, batch_shapes=(1, 4, 16))
    eng = dataset.engine("auto", runtime=cfg)

    REPRO_RT_TRACE_SAMPLE=1.0 python -m repro_torch.launch.serve ...
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Tuple

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


def _env_shapes(name: str, default: Tuple[int, ...]) -> Tuple[int, ...]:
    raw = os.environ.get(name)
    if raw is None:
        return default
    shapes = tuple(int(tok) for tok in raw.replace(",", " ").split())
    if not shapes or min(shapes) < 1:
        raise ValueError(f"{name} must be positive ints, got {raw!r}")
    return tuple(sorted(set(shapes)))


class RuntimeConfig:
    """All serving and adaptive-runtime knobs, with ``REPRO_RT_*`` env
    overrides.

    Keyword arguments override both the defaults and the environment;
    unknown names raise (typos must not silently become dead knobs).
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 **overrides):
        ######## Backend router ########
        # measured executions per (signature, backend) before the router
        # starts exploiting the observed winner
        self.router_warmup = _env_int("REPRO_RT_WARMUP", 2)
        # after convergence, every Nth request of a signature re-probes a
        # non-winning backend (drift detection for losers that improved;
        # a winner that degrades is caught by its own EWMA)
        self.router_probe_every = _env_int("REPRO_RT_PROBE_EVERY", 32)
        # EWMA smoothing for per-backend latency estimates
        self.router_alpha = _env_float("REPRO_RT_ALPHA", 0.3)
        # first N observations per (signature, backend) are discarded
        # from the EWMA: they carry first-touch time (table uploads,
        # kernel loads), not steady-state latency (they still advance
        # the warmup counter)
        self.router_discard = _env_int("REPRO_RT_DISCARD", 1)
        # ring-buffer length of the per-decision log in runtime_report()
        self.router_log_size = _env_int("REPRO_RT_LOG_SIZE", 256)
        # every Nth request of a signature clears its *fallback*
        # exclusions so backends that gained coverage are re-tried;
        # ``failed`` exclusions (prepare raised) stay permanent.
        # 0 disables.
        self.router_readmit_every = _env_int("REPRO_RT_READMIT_EVERY", 512)

        ######## Query planner ########
        # join-order planner: "greedy" is the paper's Algorithm 4
        # (#bound values, table size); "estimate" enumerates orders by
        # estimated intermediate cardinality (repro_torch.core.estimate)
        # and falls back to greedy on catalogs without distinct-count
        # statistics.  Part of the Engine's plan-cache key, so flipping
        # it mid-session re-plans instead of serving a stale order.
        self.planner = _env_str("REPRO_RT_PLANNER", "greedy")

        ######## Batch-shape tuner ########
        # launches a bucket needs before it can be retired (or retire
        # a rival); discarded launches do not count
        self.tuner_min_samples = _env_int("REPRO_RT_TUNER_MIN_SAMPLES", 3)
        # bucket B is retired when its per-slot time exceeds a smaller
        # active bucket's by this factor — batching that measures slower
        # than less batching is pure loss
        self.tuner_margin = _env_float("REPRO_RT_TUNER_MARGIN", 1.1)
        self.tuner_alpha = _env_float("REPRO_RT_TUNER_ALPHA", 0.3)
        # first N launches per bucket shape carry first-touch time;
        # discard
        self.tuner_discard = _env_int("REPRO_RT_TUNER_DISCARD", 1)

        ######## Static analysis ########
        # run the plan/IR verifier (repro_torch.analysis.verifier) over
        # every prepared artifact inside Engine prepare; violations raise
        # PlanVerificationError before anything is cached or launched.
        # Off by default (host work on every plan-cache miss; explain()
        # reports the verdict either way)
        self.verify_plans = _env_bool("REPRO_RT_VERIFY_PLANS", False)

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
        # static batch-shape menu (the Engine pads a batch that is one
        # launch up to these); the tuner retires entries it measures as
        # regressions
        self.batch_shapes = _env_shapes("REPRO_RT_BATCH_SHAPES",
                                        (1, 2, 4, 8, 16, 32))
        # largest bucket the micro-batcher lets fill, and how long the
        # oldest queued request may wait for batch-mates (checked on
        # every submit; not on the distributed backend, see
        # repro_torch.serve.batcher)
        self.max_batch = _env_int("REPRO_RT_MAX_BATCH", 32)
        self.flush_ms = _env_float("REPRO_RT_FLUSH_MS", 2.0)

        # injectable time source (seconds); every latency the engine,
        # tracer, batcher, router and tuner see is measured through this
        self.clock = clock

        for name, value in overrides.items():
            if not hasattr(self, name):
                raise ValueError(f"unknown RuntimeConfig knob {name!r}")
            setattr(self, name, value)
        if isinstance(self.batch_shapes, (list, tuple)):
            self.batch_shapes = tuple(sorted(set(int(s)
                                                 for s in self.batch_shapes)))
        if not self.batch_shapes or min(self.batch_shapes) < 1:
            raise ValueError("batch_shapes must be positive ints")
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
