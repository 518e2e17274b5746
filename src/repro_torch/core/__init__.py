"""S2RDF core: ExtVP partitioning schema, SPARQL compiler and the
static-capacity executor, in PyTorch form."""
