"""Attention — port of the GQA/MHA half of ``repro.models.attention``:
chunked online-softmax attention and the attention layer with its KV cache.

:func:`chunked_attention` keeps the JAX package's numerics: f32 logits and
running max and sum, probabilities cast to the K/V dtype before the PV
product (accumulated in f32), masked logits at ``_NEG``, a position
attending where ``0 <= q_pos - kv_pos < window`` (``GLOBAL_WINDOW``: no
bound) and below ``kv_len``, query head h reading KV head h // (H / KH).
A Python loop over KV chunks stands in for ``lax.scan``.  MLA waits for
the LM stack (ROADMAP.md queue A).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import apply_rope, dtype_of
from repro_torch.models.param_utils import Init

__all__ = ["attn_apply", "attn_init", "chunked_attention"]

_NEG = -1e30


def _softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_positions: torch.Tensor, window, kv_len=None,
                      causal: bool = True, softcap: float | None = None,
                      chunk: int = 1024,
                      scale: float | None = None) -> torch.Tensor:
    """q (B, Sq, H, Dk); k (B, Skv, KH, Dk); v (B, Skv, KH, Dv).

    q_positions (Sq,): the queries' global positions (KV positions are
    0..Skv-1).  window: attend iff 0 <= q_pos - kv_pos < window.  kv_len:
    KV slots >= kv_len are invalid (decode caches); an int or a 0-d
    integer tensor (a CUDA graph's decode reads it on the device).
    Returns (B, Sq, H, Dv) in q's dtype; softmax math in f32."""
    b, sq, h, dk = q.shape
    _, skv, kh, _ = k.shape
    dv = v.shape[-1]
    assert h % kh == 0, (h, kh)
    g = h // kh
    f32 = torch.float32
    scale = dk ** -0.5 if scale is None else scale
    chunk = min(chunk, skv)
    pad = (-skv) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    nkc = (skv + pad) // chunk
    kv_len = skv if kv_len is None else kv_len
    window = int(window)

    qr = (q.float() * scale).reshape(b, sq, kh, g, dk)
    qpos = q_positions.to(torch.int64)
    m = torch.full((b, sq, kh, g), _NEG, dtype=f32, device=q.device)
    l = torch.zeros((b, sq, kh, g), dtype=f32, device=q.device)
    acc = torch.zeros((b, sq, kh, g, dv), dtype=f32, device=q.device)
    for ci in range(nkc):
        kci = k[:, ci * chunk:(ci + 1) * chunk]               # (B, C, KH, D)
        vci = v[:, ci * chunk:(ci + 1) * chunk]
        logits = torch.einsum("bskgd,bckd->bskgc", qr, kci.float())
        logits = _softcap(logits, softcap)
        kvpos = ci * chunk + torch.arange(chunk, device=q.device)
        delta = qpos[:, None] - kvpos[None, :]                # (Sq, C)
        ok = kvpos[None, :] < kv_len
        if causal:
            ok = ok & (delta >= 0) & (delta < window)
        else:
            ok = ok & (delta.abs() < window)
        logits = logits.masked_fill(~ok[None, :, None, None, :], _NEG)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # probabilities in the K/V dtype; running max and sum stay f32
        p = torch.exp(logits - m_new[..., None]).to(kci.dtype)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.float().sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bskgc,bckd->bskgd", p.float(), vci.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, h, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# Standard GQA/MHA attention layer
# ---------------------------------------------------------------------------

#: The attention leaves each use casts to the compute dtype.
ATTN_WEIGHTS = ("wq", "wk", "wv", "wo")


def attn_init(seed: int, cfg, device="cpu") -> dict:
    """The projections of one GQA layer (the QKV biases of
    ``cfg.qkv_bias`` come with the LM stack, ROADMAP.md queue A)."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    b = Init(seed, dtype_of(cfg.param_dtype), device)
    b.dense("wq", (d, qd))
    b.dense("wk", (d, kvd))
    b.dense("wv", (d, kvd))
    b.dense("wo", (qd, d))
    return b.done()


def attn_apply(p, x: torch.Tensor, *, cfg, positions: torch.Tensor, window,
               cache=None, decode_pos=None, in_place: bool = False):
    """x (B, S, d).  Returns (out (B, S, d), new cache or (k, v)).

    Without a cache (train): returns the computed (k, v).  With one —
    dict(k=(B, Smax, KH, D), v=...) — writes k and v at rows
    ``decode_pos + arange(S)`` (``decode_pos`` an int or a 0-d integer
    tensor) and attends over the whole cache below ``kv_len = decode_pos
    + S``.  The write goes into a copy of each (the JAX package's
    functional update) or, with ``in_place``, into the cache's own
    tensors: the port's counterpart of the JAX serve step's donated
    cache, for a step that owns its cache (a CUDA graph's)."""
    bsz, s, _ = x.shape
    cdt = x.dtype
    q = x @ p["wq"].to(cdt)
    k = x @ p["wk"].to(cdt)
    v = x @ p["wv"].to(cdt)
    q = q.reshape(bsz, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(bsz, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(bsz, s, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = (k, v)
    kv_len = None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        if not in_place:
            ck, cv = ck.clone(), cv.clone()
        rows = decode_pos + torch.arange(s, device=x.device)
        ck.index_copy_(1, rows, k.to(ck.dtype))
        cv.index_copy_(1, rows, v.to(cv.dtype))
        k, v = ck, cv
        kv_len = decode_pos + s
        new_cache = dict(k=ck, v=cv)

    out = chunked_attention(q, k.to(cdt), v.to(cdt), q_positions=positions,
                            window=window, kv_len=kv_len,
                            softcap=cfg.attn_logit_softcap,
                            chunk=cfg.attn_chunk)
    out = out.reshape(bsz, s, cfg.q_dim) @ p["wo"].to(cdt)
    return out, new_cache
