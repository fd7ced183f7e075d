"""Hymba block — port of ``repro.models.hymba``: parallel attention and
Mamba (SSM) heads (arXiv:2411.13676).

Both paths read the same pre-normed input; their outputs are RMS-normed
and averaged (the paper's fused-head mean).  Sliding-window attention
everywhere but the listed global layers; the SSM path has no window (its
state carries the whole context).  Meta-tokens are not modelled, as in the
JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, layers, ssm
from repro_torch.models.param_utils import Init, fold_in

__all__ = ["hymba_block_apply", "hymba_block_init"]


def hymba_block_init(seed: int, cfg, device, *, with_axes: bool = False):
    b = Init(seed, layers.dtype_of(cfg.param_dtype), device,
             with_axes=with_axes)
    b.sub("attn", attention.attn_init(fold_in(seed, 1), cfg, device,
                                      with_axes=True))
    b.sub("mamba", ssm.mamba_init(fold_in(seed, 2), cfg, d_inner=cfg.d_model,
                                  device=device, with_axes=True))
    b.ones("norm_attn", (cfg.d_model,), ("embed",))
    b.ones("norm_mamba", (cfg.d_model,), ("embed",))
    return b.done()


def hymba_block_apply(p, x: torch.Tensor, *, cfg, positions: torch.Tensor,
                      window, cache=None, decode_pos=None,
                      in_place: bool = False, sc=lambda x, ax: x):
    """x (B, S, d) pre-normed.  cache: dict(attn=..., conv=..., ssm=...).
    A one-token input with a cache takes the Mamba decode step; longer
    inputs run the prefill scan.  ``in_place``: the KV write goes into
    the cache's own tensors (``attention.attn_apply``)."""
    a_out, a_cache = attention.attn_apply(
        p["attn"], x, cfg=cfg, positions=positions, window=window,
        cache=cache.get("attn") if cache else None, decode_pos=decode_pos,
        in_place=in_place, sc=sc)
    if cache is not None and x.shape[1] == 1:
        m_out, m_state, m_events = ssm.mamba_step(
            p["mamba"], x, cfg, (cache["conv"], cache["ssm"]))
    else:
        m_out, m_state = ssm.mamba_apply(p["mamba"], x, cfg, sc=sc)
        m_events = torch.zeros((), dtype=torch.float32, device=x.device)
    y = 0.5 * (layers.rms_norm(a_out, p["norm_attn"] - 1.0, cfg.norm_eps)
               + layers.rms_norm(m_out, p["norm_mamba"] - 1.0, cfg.norm_eps))
    new_cache = dict(attn=a_cache, conv=m_state[0], ssm=m_state[1])
    if cfg.mnf.enabled:
        # Per-token fired-event count of the gated state update; prefill
        # seeds zero so the cache keeps one structure.
        new_cache["events"] = m_events
    return y, new_cache

