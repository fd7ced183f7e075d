"""Attention — port of ``repro.models.attention``: chunked online-softmax
attention, the GQA/MHA layer (with optional QKV biases) and its KV cache,
its cross-attention form over precomputed keys and values (whisper's
decoder), and DeepSeek-V2's multi-head latent attention (MLA).

:func:`chunked_attention` keeps the JAX package's numerics: f32 logits and
running max and sum, probabilities cast to the K/V dtype before the PV
product (accumulated in f32), masked logits at ``_NEG``, a position
attending where ``0 <= q_pos - kv_pos < window`` (non-causal: where
``|q_pos - kv_pos| < window``; ``GLOBAL_WINDOW``: no bound) and below
``kv_len``, query head h reading KV head h // (H / KH).
A Python loop over KV chunks stands in for ``lax.scan``.

MLA keeps the JAX package's two formulations: without a cache the
expanded one (keys and values decompressed from the latent, then
:func:`chunked_attention`); with a cache — the prefill too — the absorbed
one, scoring the queries directly against the compressed cache in f32.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import apply_rope, dtype_of, mm, split_heads
from repro_torch.models.param_utils import Init

__all__ = ["ATTN_WEIGHTS", "MLA_WEIGHTS", "attn_apply", "attn_init",
           "chunked_attention", "mla_apply", "mla_init"]

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
    Returns (B, Sq, H, Dv) in q's dtype; softmax math in f32.  On
    DTensors each rank attends its own batch rows, its q, k and v
    gathered whole on every other dim (``parallel.sharding.batch_local``:
    the einsums flatten the head dims, which DTensor cannot do sharded)."""
    if isinstance(q, DTensor):
        from repro_torch.parallel.sharding import batch_local
        return batch_local(chunked_attention, q, k, v, batched=3,
                           q_positions=q_positions, window=window,
                           kv_len=kv_len, causal=causal, softcap=softcap,
                           chunk=chunk, scale=scale)
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

#: The attention leaves each use casts to the compute dtype (the QKV
#: biases included).
ATTN_WEIGHTS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def attn_init(seed: int, cfg, device, *, with_axes: bool = False):
    """The projections of one GQA layer, and with ``cfg.qkv_bias`` the
    query, key and value biases (zeros, as the JAX package makes them)."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    b = Init(seed, dtype_of(cfg.param_dtype), device, with_axes=with_axes)
    b.dense("wq", (d, qd), ("embed", "q_heads"))
    b.dense("wk", (d, kvd), ("embed", "kv_heads"))
    b.dense("wv", (d, kvd), ("embed", "kv_heads"))
    b.dense("wo", (qd, d), ("q_heads", "embed"))
    if cfg.qkv_bias:
        b.zeros("bq", (qd,), ("q_heads",))
        b.zeros("bk", (kvd,), ("kv_heads",))
        b.zeros("bv", (kvd,), ("kv_heads",))
    return b.done()


def _write_rows(leaf, val, decode_pos, s: int, in_place: bool):
    leaf = leaf if in_place else leaf.clone()
    rows = decode_pos + torch.arange(s, device=val.device)
    leaf.index_copy_(1, rows, val.to(leaf.dtype))
    return leaf


def _write_cache(cache, new: dict, decode_pos, s: int, in_place: bool):
    """Each leaf of ``new`` (B, S, ...) written at rows ``decode_pos +
    arange(S)`` of the same leaf of ``cache`` (B, Smax, ...): into a copy
    (the JAX package's functional update) or, with ``in_place``, into the
    cache's own tensor.  Returns the written cache.  A DTensor leaf is
    written on each rank's batch rows (``parallel.sharding.batch_local``:
    ``index_copy_`` has no sharding rule in some DTensor versions)."""
    from repro_torch.parallel.sharding import batch_local
    return {name: batch_local(_write_rows, cache[name], val, batched=2,
                              decode_pos=decode_pos, s=s, in_place=in_place)
            for name, val in new.items()}


def attn_apply(p, x: torch.Tensor, *, cfg, positions: torch.Tensor, window,
               cache=None, decode_pos=None, in_place: bool = False,
               causal: bool = True, kv_override: tuple | None = None,
               sc=lambda x, ax: x):
    """x (B, S, d).  Returns (out (B, S, d), new cache or (k, v)).

    Without a cache (train): returns the computed (k, v).  With one —
    dict(k=(B, Smax, KH, D), v=...) — writes k and v at rows
    ``decode_pos + arange(S)`` (``decode_pos`` an int or a 0-d integer
    tensor) and attends over the whole cache below ``kv_len = decode_pos
    + S``.  The write goes into a copy of each (the JAX package's
    functional update) or, with ``in_place``, into the cache's own
    tensors: the port's counterpart of the JAX serve step's donated
    cache, for a step that owns its cache (a CUDA graph's).

    Cross-attention: ``kv_override=(k, v)``, each (B, Skv, KH, D), takes
    the place of the key and value projections; nothing is projected or
    cached for them, and the query is rotated only when ``causal`` (the
    encoder's keys carry no decoder positions).  ``causal=False`` masks
    on ``|q_pos - kv_pos| < window`` instead.

    Sharding (``sc``, the JAX package's points): heads over the model axis
    when they divide it, else the query sequence (``attn_seq``) with the
    small GQA K/V replicated; a cache kv_heads first, else ``cache_seq``."""
    bsz, s, _ = x.shape
    cdt = x.dtype
    q = mm(x, p["wq"].to(cdt))
    if "bq" in p:
        q = q + p["bq"].to(cdt)
    q = split_heads(q, cfg.num_heads, cfg.head_dim)
    if kv_override is None:
        k = mm(x, p["wk"].to(cdt))
        v = mm(x, p["wv"].to(cdt))
        if "bk" in p:
            k = k + p["bk"].to(cdt)
            v = v + p["bv"].to(cdt)
        k = split_heads(k, cfg.num_kv_heads, cfg.head_dim)
        v = split_heads(v, cfg.num_kv_heads, cfg.head_dim)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    else:
        if cache is not None:
            raise ValueError("cross-attention (kv_override) writes no cache")
        k, v = kv_override
        if causal:
            q = apply_rope(q, positions, cfg.rope_theta)

    q = sc(q, ("batch", "attn_seq", "heads", None))
    new_cache = (k, v)
    kv_len = None
    if cache is not None:
        new_cache = _write_cache(cache, dict(k=k, v=v), decode_pos, s,
                                 in_place)
        k, v = new_cache["k"], new_cache["v"]
        kv_len = decode_pos + s
        k = sc(k, ("batch", "cache_seq", "kv_heads", None))
        v = sc(v, ("batch", "cache_seq", "kv_heads", None))
    else:
        k = sc(k, ("batch", None, "kv_heads", None))
        v = sc(v, ("batch", None, "kv_heads", None))

    out = chunked_attention(q, k.to(cdt), v.to(cdt), q_positions=positions,
                            window=window, kv_len=kv_len, causal=causal,
                            softcap=cfg.attn_logit_softcap,
                            chunk=cfg.attn_chunk)
    out = sc(out, ("batch", "attn_seq", "heads", None))
    out = mm(out.reshape(bsz, s, cfg.q_dim), p["wo"].to(cdt))
    return out, new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed KV with decoupled RoPE
# ---------------------------------------------------------------------------

#: The MLA leaves each use casts to the compute dtype.
MLA_WEIGHTS = ("wq", "w_dkv", "w_uk", "w_uv", "wo")


def mla_init(seed: int, cfg, device, *, with_axes: bool = False):
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    b = Init(seed, dtype_of(cfg.param_dtype), device, with_axes=with_axes)
    b.dense("wq", (d, h * qk), ("embed", "q_heads"))
    b.dense("w_dkv", (d, m.kv_lora_rank + m.qk_rope_dim), ("embed", "kv_lora"))
    b.dense("w_uk", (m.kv_lora_rank, h * m.qk_nope_dim),
            ("kv_lora", "q_heads"))
    b.dense("w_uv", (m.kv_lora_rank, h * m.v_head_dim),
            ("kv_lora", "q_heads"))
    b.dense("wo", (h * m.v_head_dim, d), ("q_heads", "embed"))
    return b.done()


def mla_apply(p, x: torch.Tensor, *, cfg, positions: torch.Tensor, window,
              cache=None, decode_pos=None, in_place: bool = False,
              sc=lambda x, ax: x):
    """x (B, S, d).  Returns (out (B, S, d), new cache or (c, kr)).

    Without a cache: the expanded formulation, returning the latent c
    (B, S, kv_lora_rank) and the rotated shared key kr (B, S,
    qk_rope_dim).  With one — dict(c=(B, Smax, kv_lora_rank), kr=(B,
    Smax, qk_rope_dim)) — c and kr are written at ``decode_pos`` as
    :func:`attn_apply` writes K and V (``in_place`` alike), and the
    queries, with W_uk absorbed, score the whole cache below ``kv_len =
    decode_pos + S`` in f32; the context is taken in the latent space and
    W_uv applied after."""
    m = cfg.mla
    bsz, s, _ = x.shape
    cdt = x.dtype
    h = cfg.num_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    scale = qk ** -0.5

    q = split_heads(mm(x, p["wq"].to(cdt)), h, qk)
    q = sc(q, ("batch", "attn_seq", "heads", None))
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckr = mm(x, p["w_dkv"].to(cdt))                      # (B, S, lora+rope)
    c, kr = ckr[..., :m.kv_lora_rank], ckr[..., m.kv_lora_rank:]
    kr = apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]

    if cache is None:
        # expanded formulation (train / uncached forward)
        k_nope = split_heads(mm(c, p["w_uk"].to(cdt)), h, m.qk_nope_dim)
        value = split_heads(mm(c, p["w_uv"].to(cdt)), h, m.v_head_dim)
        k_nope = sc(k_nope, ("batch", None, "heads", None))
        value = sc(value, ("batch", None, "heads", None))
        kfull = torch.cat([k_nope, kr[:, :, None, :].expand(
            bsz, s, h, m.qk_rope_dim)], dim=-1)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        out = chunked_attention(qfull, kfull, value, q_positions=positions,
                                window=window, causal=True,
                                softcap=cfg.attn_logit_softcap,
                                chunk=cfg.attn_chunk, scale=scale)
        out = mm(out.reshape(bsz, s, h * m.v_head_dim), p["wo"].to(cdt))
        return out, (c, kr)

    # absorbed formulation: scores against the compressed cache
    new_cache = _write_cache(cache, dict(c=c, kr=kr), decode_pos, s,
                             in_place)
    from repro_torch.parallel.sharding import batch_local
    out = batch_local(_mla_absorbed, q_nope, q_rope, new_cache["c"],
                      new_cache["kr"], p["w_uk"], p["w_uv"], batched=4,
                      cfg=cfg, positions=positions, kv_len=decode_pos + s,
                      window=window)
    out = mm(out.reshape(bsz, s, h * m.v_head_dim), p["wo"].to(cdt))
    return out, new_cache


def _mla_absorbed(q_nope, q_rope, cc, ckr_c, w_uk, w_uv, *, cfg, positions,
                  kv_len, window):
    """MLA's absorbed attention (B, S, H, v_head_dim): W_uk folded into
    the queries, scores against the compressed cache ``cc`` and its rotated
    keys ``ckr_c`` below ``kv_len`` in f32, the context taken in the
    latent space and W_uv applied after.  Batch-local (``mla_apply`` runs
    it on each rank's rows on a mesh)."""
    m = cfg.mla
    h = cfg.num_heads
    cdt = q_nope.dtype
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    wk = w_uk.to(cdt).reshape(m.kv_lora_rank, h, m.qk_nope_dim)
    q_c = torch.einsum("bshn,lhn->bshl", q_nope, wk)        # absorb W_uk
    logits = (torch.einsum("bshl,btl->bsht", q_c.float(), cc.float())
              + torch.einsum("bshr,btr->bsht", q_rope.float(),
                             ckr_c.float())) * scale
    tpos = torch.arange(cc.shape[1], device=cc.device)
    delta = positions.to(torch.int64)[:, None] - tpos[None, :]  # (S, T)
    ok = (tpos[None, :] < kv_len) & (delta >= 0) & (delta < int(window))
    logits = logits.masked_fill(~ok[None, :, None, :], _NEG)
    probs = torch.softmax(logits, dim=-1)
    ctx_c = torch.einsum("bsht,btl->bshl", probs,
                         cc.float()).to(cdt)                # (B, S, H, lora)
    wv = w_uv.to(cdt).reshape(m.kv_lora_rank, h, m.v_head_dim)
    return torch.einsum("bshl,lhv->bshv", ctx_c, wv)        # absorb W_uv
