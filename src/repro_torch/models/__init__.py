"""The paper's CNN workloads (port of repro.models.cnn)."""
