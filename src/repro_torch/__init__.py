"""repro_torch — the Multiply-and-Fire event engine in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

A port of the JAX package ``repro`` (kept in the repository as the
reference).  It imports neither JAX nor ``repro``.  Layout mirrors the
reference: ``core/`` (event encoding, fire, oracles), ``costmodel/``
(routing), ``engine/`` (config, registry, streams, backends, ops),
``kernels/<name>/{ref,kernel,ops}.py`` (plain version, CUDA launcher,
counting wrapper; CUDA sources in ``csrc/``), ``models/`` (the CNNs).
Kernels are built with ``nvcc`` at their first launch, never at import.
"""
from repro_torch.device import default_device

__all__ = ["default_device"]
