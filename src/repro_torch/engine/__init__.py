"""Public API: ``Dataset`` + ``Engine`` over the torch backend, and the
serving layer's ``RuntimeConfig``, ``ServerMetrics`` and
``SparqlServer``."""

from repro_torch.engine.backends import (
    ExecutionBackend, ExecutionContext, PreparedQuery, TorchBackend,
    available_backends, create_backend, register_backend,
)
from repro_torch.engine.dataset import Dataset
from repro_torch.engine.engine import (
    Engine, PlanCache, ServerMetrics, resolve_device,
)
from repro_torch.engine.result import Bindings, Result
from repro_torch.engine.template import (
    ConstantBinding, QueryTemplate, template_signature,
)
from repro_torch.runtime import RuntimeConfig

__all__ = ["Dataset", "Engine", "Result", "Bindings", "ExecutionContext",
           "ExecutionBackend", "register_backend", "create_backend",
           "available_backends",
           "PreparedQuery", "TorchBackend", "PlanCache", "resolve_device",
           "ConstantBinding", "QueryTemplate", "template_signature",
           "RuntimeConfig", "ServerMetrics", "SparqlServer"]

# last: the server sits on top of the engine (it imports the names above)
from repro_torch.serve import SparqlServer  # noqa: E402
