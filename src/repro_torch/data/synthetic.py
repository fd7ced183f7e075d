"""Deterministic synthetic data: stateless token streams and CNN inputs —
port of ``repro.data.synthetic``.

A batch is a pure function of (seed, step, host shard): the numpy draws
are the JAX package's, value for value (``SeedSequence([seed, *xs])``),
so both packages see the same batches and a restart resumes exactly with
no iterator state to checkpoint.  Results are torch tensors on
``device``: the card (``default_device()``) unless the caller asks for
another (``"cpu"``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import default_device

__all__ = ["TokenStreamConfig", "lm_batch", "markov_lm_batch", "cnn_batch"]


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _fold(seed: int, *xs: int) -> np.random.Generator:
    ss = np.random.SeedSequence([seed, *xs])
    return np.random.default_rng(ss)


def _to(x: np.ndarray, device) -> torch.Tensor:
    dev = default_device() if device is None else torch.device(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def lm_batch(cfg: TokenStreamConfig, step: int, *, host_index: int = 0,
             host_count: int = 1, device=None) -> dict:
    """Uniform-random int32 tokens (throughput benchmarking):
    {"tokens", "labels"}, each (global_batch / host_count, seq_len)."""
    per_host = cfg.global_batch // host_count
    rng = _fold(cfg.seed, step, host_index)
    toks = rng.integers(0, cfg.vocab_size, (per_host, cfg.seq_len + 1),
                        dtype=np.int32)
    return dict(tokens=_to(toks[:, :-1], device),
                labels=_to(toks[:, 1:], device))


def markov_lm_batch(cfg: TokenStreamConfig, step: int, *, order: int = 1,
                    host_index: int = 0, host_count: int = 1,
                    device=None) -> dict:
    """A learnable synthetic language: a fixed random Markov chain over the
    vocab (each token has 8 likely successors, 5% noise), the same
    transition table at every step, so a trained model's loss falls."""
    per_host = cfg.global_batch // host_count
    table_rng = _fold(cfg.seed, 0xC0FFEE)
    v = cfg.vocab_size
    successors = table_rng.integers(0, v, (v, 8), dtype=np.int32)
    rng = _fold(cfg.seed, step, host_index)
    toks = np.empty((per_host, cfg.seq_len + 1), np.int32)
    toks[:, 0] = rng.integers(0, v, per_host)
    choices = rng.integers(0, 8, (per_host, cfg.seq_len))
    noise = rng.random((per_host, cfg.seq_len)) < 0.05
    rand_tok = rng.integers(0, v, (per_host, cfg.seq_len), dtype=np.int32)
    for t in range(cfg.seq_len):
        nxt = successors[toks[:, t], choices[:, t]]
        toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
    return dict(tokens=_to(toks[:, :-1], device),
                labels=_to(toks[:, 1:], device))


def cnn_batch(batch: int, size: int, channels: int, step: int, *,
              seed: int = 0, activation_sparsity: float = 0.5,
              device=None) -> torch.Tensor:
    """ReLU-like sparse f32 images (batch, size, size, channels) for the
    MNF CNN pipeline: |normal| with a share ``activation_sparsity`` of the
    values zeroed."""
    rng = _fold(seed, step)
    x = rng.standard_normal((batch, size, size, channels)).astype(np.float32)
    mask = rng.random((batch, size, size, channels)) >= activation_sparsity
    return _to(np.abs(x) * mask, device)
