"""B8: the fire-gated Mamba decode step."""
