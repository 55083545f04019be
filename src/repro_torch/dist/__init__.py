"""Cross-client collectives of the port."""
