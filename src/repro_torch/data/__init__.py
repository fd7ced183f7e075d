"""Deterministic synthetic data and the prefetching loader (port of
``repro.data``)."""
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import (TokenStreamConfig, cnn_batch,
                                        lm_batch, markov_lm_batch)

__all__ = ["PrefetchLoader", "TokenStreamConfig", "cnn_batch", "lm_batch",
           "markov_lm_batch"]
