"""Event encoding, fire and the dense/event oracles (port of repro.core)."""
