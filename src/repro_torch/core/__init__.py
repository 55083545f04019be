"""Core math of the port: transforms, draws, beta, chunking, estimators, codec."""
