"""Elastic scaling, failure handling and straggler mitigation.

This container has one host, so the *policies* are implemented against an
abstract cluster membership interface and unit-tested with simulated
failures; on a real multi-host deployment `ClusterView` reads the JAX
distributed runtime (coordinator heartbeats) instead of the injected
callbacks.  The mechanisms:

* **Failure detection** — heartbeat timestamps per host; a host silent
  for ``timeout_s`` is declared dead.
* **Elastic re-mesh** — given the surviving host set, pick the largest
  mesh (pods × data × model) we can build with the configured model-axis
  size, re-shard from the last checkpoint (checkpoint.py restores onto
  any mesh), and scale the per-host batch to preserve the global batch.
* **Straggler mitigation** — per-step host timings feed an EWMA; hosts
  slower than ``straggler_factor ×`` median for ``patience`` consecutive
  steps are treated as failed (synchronous data parallelism means one
  straggler gates the fleet — eject-and-reshard beats waiting, cf.
  backup workers in large-scale SGD).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ClusterView", "ElasticPolicy", "MeshPlan", "StragglerDetector"]


@dataclass
class MeshPlan:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    n_hosts: int
    per_host_batch: int

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape))


@dataclass
class ClusterView:
    """Membership via heartbeats (injected clock for tests)."""

    timeout_s: float = 30.0
    _last_seen: Dict[str, float] = field(default_factory=dict)

    def heartbeat(self, host: str, now: Optional[float] = None) -> None:
        self._last_seen[host] = time.monotonic() if now is None else now

    def alive(self, now: Optional[float] = None) -> List[str]:
        t = time.monotonic() if now is None else now
        return sorted(h for h, seen in self._last_seen.items()
                      if t - seen <= self.timeout_s)

    def dead(self, now: Optional[float] = None) -> List[str]:
        t = time.monotonic() if now is None else now
        return sorted(h for h, seen in self._last_seen.items()
                      if t - seen > self.timeout_s)


@dataclass
class ElasticPolicy:
    """Chooses the mesh after membership changes.

    Keeps the model axis fixed (TP degree is a property of the model
    fitting in HBM, not of cluster size) and scales the data/pod axes to
    the largest usable host count; global batch is preserved by scaling
    per-host batch, so optimizer hyperparameters stay valid.
    """

    devices_per_host: int = 4
    model_axis: int = 16
    global_batch: int = 256

    def plan(self, n_hosts: int) -> MeshPlan:
        if n_hosts <= 0:
            raise RuntimeError("no hosts alive")
        total = n_hosts * self.devices_per_host
        if total < self.model_axis:
            # degenerate cluster: shrink TP (restore handles resharding)
            model = 1 << int(np.floor(np.log2(total)))
            data = total // model
        else:
            model = self.model_axis
            data = total // model
        # keep data a divisor of global batch for exact microbatching
        while data > 1 and self.global_batch % data != 0:
            data -= 1
        used = data * model
        per_host_batch = max(1, self.global_batch // data)
        return MeshPlan(shape=(data, model), axis_names=("data", "model"),
                        n_hosts=used // self.devices_per_host or 1,
                        per_host_batch=per_host_batch)


@dataclass
class StragglerDetector:
    straggler_factor: float = 1.8
    patience: int = 3
    ewma: float = 0.5
    _avg: Dict[str, float] = field(default_factory=dict)
    _strikes: Dict[str, int] = field(default_factory=dict)

    def observe(self, timings: Dict[str, float]) -> List[str]:
        """Feed per-host step seconds; returns hosts to eject."""
        for h, t in timings.items():
            prev = self._avg.get(h, t)
            self._avg[h] = (1 - self.ewma) * prev + self.ewma * t
        med = float(np.median(list(self._avg.values())))
        out = []
        for h, avg in self._avg.items():
            if avg > self.straggler_factor * med:
                self._strikes[h] = self._strikes.get(h, 0) + 1
                if self._strikes[h] >= self.patience:
                    out.append(h)
            else:
                self._strikes[h] = 0
        return sorted(out)

    def forget(self, host: str) -> None:
        self._avg.pop(host, None)
        self._strikes.pop(host, None)
