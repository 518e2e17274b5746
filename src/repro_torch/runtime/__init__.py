"""Adaptive execution runtime: measured, self-tuning serving decisions.

* :class:`RuntimeConfig` centralizes every runtime knob with
  ``REPRO_RT_*`` env overrides and an injectable clock.
* :class:`BackendRouter` routes each template signature to the backend
  (eager / torch / distributed) its own measured latencies favor, with
  warmup, periodic re-probing, and deterministic exclusion of backends
  that failed to prepare or fell back to the host path.
* :class:`BatchTuner` adapts the micro-batch shape menu from observed
  per-slot latency and occupancy, retiring bucket sizes that measure
  slower than smaller ones.

``Engine(dataset, backend="auto")`` (and ``SparqlServer(...,
backend="auto")``, ``repro_torch.launch.serve --backend auto``) wires
all three together; ``engine.runtime_report()`` snapshots every
decision.
"""

from repro_torch.runtime.config import RuntimeConfig, runtime_config
from repro_torch.runtime.router import BackendRouter, RouteDecision
from repro_torch.runtime.tuner import BatchTuner

__all__ = ["RuntimeConfig", "runtime_config", "BackendRouter",
           "RouteDecision", "BatchTuner"]
