"""Public API: ``Dataset`` + ``Engine`` over the torch backend."""

from repro_torch.engine.backends import (
    ExecutionContext, PreparedQuery, TorchBackend,
)
from repro_torch.engine.dataset import Dataset
from repro_torch.engine.engine import Engine, PlanCache, resolve_device
from repro_torch.engine.result import Bindings, Result
from repro_torch.engine.template import (
    ConstantBinding, QueryTemplate, template_signature,
)

__all__ = ["Dataset", "Engine", "Result", "Bindings", "ExecutionContext",
           "PreparedQuery", "TorchBackend", "PlanCache", "resolve_device",
           "ConstantBinding", "QueryTemplate", "template_signature"]
