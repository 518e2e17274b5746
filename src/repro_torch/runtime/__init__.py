"""Runtime knobs of the serving layer (:class:`RuntimeConfig`)."""

from repro_torch.runtime.config import RuntimeConfig, runtime_config

__all__ = ["RuntimeConfig", "runtime_config"]
