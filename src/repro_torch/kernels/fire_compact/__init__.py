"""B1: fused fire + occupancy (csrc/fire_compact.cu)."""
