"""B4: event-native max-pools, both grids (csrc/event_pool.cu)."""
