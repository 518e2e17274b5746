"""S2RDF on PyTorch: ExtVP storage + the SPARQL engine on an NVIDIA GPU.

The public API mirrors the JAX package's facade:

    from repro_torch import Dataset

    ds = Dataset.watdiv(scale=0.5, threshold=0.25)           # device "cuda"
    res = ds.engine().query("SELECT * WHERE { ?u wsdbm:follows ?v }")

Entry points (``Dataset``, ``Engine``, ``SparqlServer``, ``python -m
repro_torch.launch.serve``) run on the card unless the caller passes
``device="cpu"``.
The join probe of every join runs in a hand-written CUDA kernel
(:mod:`repro_torch.kernels`), built from ``kernels/csrc/`` at first use.
"""

from repro_torch.engine import (
    Dataset, Engine, PreparedQuery, QueryTemplate, Result, RuntimeConfig,
    ServerMetrics, template_signature,
)
from repro_torch.serve import SparqlServer

__all__ = ["Dataset", "Engine", "PreparedQuery", "QueryTemplate", "Result",
           "RuntimeConfig", "ServerMetrics", "SparqlServer",
           "template_signature"]
