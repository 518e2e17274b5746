"""RDF data substrate: dictionary encoding and the WatDiv-like generator."""

from repro_torch.rdf.dictionary import Dictionary, PAD, UNBOUND
from repro_torch.rdf.generator import WatDivConfig, generate_watdiv

__all__ = ["Dictionary", "PAD", "UNBOUND", "WatDivConfig", "generate_watdiv"]
