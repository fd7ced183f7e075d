"""Layer primitives — the parts of ``repro.models.layers`` the port's
models need: the dense max-pool oracle of the CNN, and the LM's norm,
embeddings and MNF fire point.

LM apply-functions take params as dicts of tensors and compute in
``cfg.compute_dtype`` with f32 norm internals, as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.models.param_utils import Init

__all__ = ["dtype_of", "embed_apply", "embed_init", "max_pool_nhwc",
           "mnf_sparsify", "rms_norm", "unembed_matrix"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("bfloat16", ...)."""
    return _DTYPES[name]


def max_pool_nhwc(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """VALID k×k max-pool over the spatial axes of a (B, H, W, C) map.

    The dense oracle of the event-native pool (bitwise equal to it: max is
    exact), written as a window view and a max so that no library pooling
    operator stands in for the event kernels."""
    win = x.unfold(1, k, stride).unfold(2, k, stride)   # (B, OH, OW, C, k, k)
    return win.amax(dim=(-2, -1))


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, scaled by ``1 + gamma`` (the models store the gain
    as ``ln - 1``), cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + gamma.float())).to(dt)


def mnf_sparsify(h: torch.Tensor, cfg) -> torch.Tensor:
    """The MNF fire phase on hidden activations plus block-event masking
    for the down projection (``engine.sparsify``); the identity when MNF
    is off, and at threshold 0 on a ReLU-family activation."""
    m = cfg.mnf
    if not m.enabled:
        return h
    from repro_torch import engine
    return engine.sparsify(h, engine.EngineConfig.from_mnf(m))


def embed_init(seed: int, cfg, device="cpu") -> dict:
    b = Init(seed, dtype_of(cfg.param_dtype), device)
    # 1/sqrt(d) rows: keeps tied-unembedding logits at unit scale.
    b.dense("tok", (cfg.vocab_size, cfg.d_model), scale=cfg.d_model ** -0.5)
    if not cfg.tie_embeddings:
        b.dense("unembed", (cfg.d_model, cfg.vocab_size))
    return b.done()


def embed_apply(p: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Embedding rows (f32) gathered, then cast to the compute dtype
    (``index_select``: far less host time than advanced indexing of the
    (V, d) table; PERF.md §5)."""
    cdt = dtype_of(cfg.compute_dtype)
    emb = p["tok"].index_select(0, tokens.reshape(-1)).reshape(
        *tokens.shape, -1).to(cdt)
    if cfg.tie_embeddings:
        emb = emb * torch.tensor(float(cfg.d_model), dtype=cdt) ** 0.5
    return emb


def unembed_matrix(p: dict, cfg) -> torch.Tensor:
    """The (d, V) unembedding in the compute dtype (the logits multiply
    its bf16-rounded values in f32)."""
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.tie_embeddings:
        return p["tok"].T.to(cdt)
    return p["unembed"].to(cdt)
