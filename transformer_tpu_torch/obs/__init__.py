"""Observability primitives of the port (standard library only)."""
