"""Routing cost models (port of the parts of repro.costmodel routing needs)."""
