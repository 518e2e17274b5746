"""Serving runtime: the micro-batched SPARQL query server."""

from repro_torch.serve.batcher import MicroBatcher, PendingQuery
from repro_torch.serve.engine import ServerMetrics, SparqlServer

__all__ = ["SparqlServer", "ServerMetrics", "MicroBatcher", "PendingQuery"]
