"""B7: the fire-gated WKV6 decode step."""
