"""Deterministic synthetic data (port of ``repro.data``; the prefetching
loader is still to port)."""
from repro_torch.data.synthetic import (TokenStreamConfig, cnn_batch,
                                        lm_batch, markov_lm_batch)

__all__ = ["TokenStreamConfig", "cnn_batch", "lm_batch", "markov_lm_batch"]
