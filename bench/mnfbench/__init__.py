"""The port's benchmark harness: cells of ``BENCHMARK.json`` run against
``repro_torch`` on the card, held to a plain PyTorch reference.

Nothing here imports ``jax``, ``jaxlib`` or the JAX package ``repro``;
only the systems (``systems/*.py``) import the port (``repro_torch``).
"""
