"""Command-line entry points of the port (repro/launch counterparts)."""
