"""Recurrent blocks — port of ``repro.models.ssm``: RWKV6 (Finch) and
Mamba1 (the selective SSM of Hymba's parallel heads).

RWKV6 prefill runs the chunked matmul form of the WKV6 recurrence
(:func:`wkv6_chunked`, plain torch, f32), exact against the sequential
recurrence while the per-step log-decay stays above the stability clamp
``WKV_LOG_DECAY_MIN`` (DESIGN.md §8); the exact recurrence is the op B9'
(``kernels.wkv6``), which no model calls.  Mamba prefill
(:func:`mamba_apply`) runs the selective scan sequentially over time in
f32, one call of B10 (``kernels.mamba_scan.mamba_scan_fused``) per scan
chunk — on the card one kernel launch, on the CPU its plain loop: the JAX
package's associative scan has no torch counterpart, and the two sum in
different orders (the tests hold them at 1e-4).
Decode runs one step per token: the dense step or, with MNF on, the
fire-gated step (DESIGN.md §13), whose state update goes through the
engine's ``recurrent_step`` — kernel B7 (RWKV6) or B8 (Mamba) on the card.

Weight casts follow the JAX package: every block matmul multiplies the
weight cast to the compute dtype (a copy made once at load,
``models.transformer.compute_params``, gives the same bits); the decay
LoRA, the WKV and SSM states and the Mamba decay run in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan.ops import mamba_scan_fused
from repro_torch.models import layers
from repro_torch.models.param_utils import Init

__all__ = ["MAMBA_WEIGHTS", "MATMUL_WEIGHTS", "WKV_LOG_DECAY_MIN",
           "mamba_apply", "mamba_init", "mamba_step", "rwkv6_block_apply",
           "rwkv6_block_decode", "rwkv6_block_init", "wkv6_chunked",
           "wkv6_step", "wkv6_step_gated"]

# Per-step log-decay clamp for the chunked-parallel path: with chunk C the
# largest inverse-decay exponent is C*|min|; C=32 * 2.5 = 80 < log(f32 max).
WKV_LOG_DECAY_MIN = -2.5


# ---------------------------------------------------------------------------
# WKV6 recurrence — chunked matmul formulation (prefill)
# ---------------------------------------------------------------------------

def wkv6_chunked(r, k, v, w, u, s0=None, *, chunk: int = 32):
    """r, k, v, w (B, H, T, D); u (H, D); s0 (B, H, D, D) or None.

    Exact (against the sequential recurrence) for w >= exp(min clamp);
    smaller decays are clamped.  Returns (o (B, H, T, D) f32, s_final)."""
    b, h, t, d = r.shape
    pad = (-t) % chunk
    if pad:
        r, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (r, k, v))
        w = F.pad(w, (0, 0, 0, pad), value=1.0)
    nc = (t + pad) // chunk
    f32 = torch.float32
    if s0 is None:
        s0 = torch.zeros((b, h, d, d), dtype=f32, device=r.device)
    chunks = lambda x: x.float().reshape(b, h, nc, chunk, d).unbind(2)
    w_min = torch.exp(torch.tensor(WKV_LOG_DECAY_MIN, dtype=f32)).item()
    lw = torch.log(torch.clamp(w.float(), w_min, 1.0))
    uf = u.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=f32, device=r.device),
                     diagonal=-1)                            # strict lower
    s = s0.float()
    outs = []
    for rci, kci, vci, lwi in zip(chunks(r), chunks(k), chunks(v),
                                  chunks(lw)):               # (B, H, C, D)
        lp = torch.cumsum(lwi, dim=2) - lwi                  # exclusive
        lpc = lp[:, :, -1:, :] + lwi[:, :, -1:, :]           # total decay
        rq = rci * torch.exp(lp)
        kk = kci * torch.exp(-(lp + lwi))                    # bounded by clamp
        a = torch.einsum("bhtd,bhsd->bhts", rq, kk) * tri
        diag = torch.einsum("bhtd,hd,bhtd->bht", rci, uf, kci)
        outs.append(torch.einsum("bhts,bhsd->bhtd", a, vci)
                    + diag[..., None] * vci
                    + torch.einsum("bhtd,bhde->bhte", rq, s))
        ks = kci * torch.exp(lpc - (lp + lwi))               # <= 1, safe
        s = (torch.exp(lpc[:, :, 0, :])[..., None] * s
             + torch.einsum("bhtd,bhte->bhde", ks, vci))
    o = torch.stack(outs, dim=2).reshape(b, h, nc * chunk, d)[:, :, :t]
    return o, s


# ---------------------------------------------------------------------------
# Decode steps
# ---------------------------------------------------------------------------

def _decode_engine_cfg(cfg):
    """The EngineConfig the fire-gated decode runs under, or None when MNF
    is off (the dense step is then the only path)."""
    if not cfg.mnf.enabled:
        return None
    from repro_torch.engine import EngineConfig
    return EngineConfig.from_mnf(cfg.mnf)


def wkv6_step(r, k, v, w, u, s):
    """Dense single decode step.  r, k, v, w (B, H, D); u (H, D); s (B, H,
    D, D).  The plain version of B7 on the undropped key
    (``kernels.wkv6_step.ref.wkv6_step_ref``), so at threshold 0 the gated
    step equals it bit for bit on the CPU."""
    from repro_torch.kernels.wkv6_step.ref import wkv6_step_ref
    b, h, d = r.shape
    fl = lambda z: z.reshape(b * h, d)
    uf = torch.broadcast_to(u, (b, h, d)).reshape(b * h, d)
    o, s_new = wkv6_step_ref(fl(r), fl(k), fl(v), fl(w), uf,
                             s.reshape(b * h, d, d))
    return o.reshape(b, h, d), s_new.reshape(b, h, d, d)


def wkv6_step_gated(r, k, v, w, u, s, ecfg):
    """Fire-gated single decode step (DESIGN.md §13): the key vector — the
    state update's increment drive — is thresholded by signed fire, and
    the state update skips dead channel-blocks.  Returns (o, s_new,
    n_events), the last the per-token scalar event count (0-d f32)."""
    from repro_torch import engine
    b, h, d = r.shape
    fl = lambda z: z.reshape(b * h, d).float()
    uf = torch.broadcast_to(u, (b, h, d)).reshape(b * h, d).float()
    stream = engine.fire_delta(fl(k), ecfg)
    o, s_new = engine.recurrent_step(
        "wkv6", stream, s.reshape(b * h, d, d), ecfg.for_recurrent(d),
        r=fl(r), v=fl(v), w=fl(w), u=uf)
    return (o.reshape(b, h, d), s_new.reshape(b, h, d, d),
            stream.num_scalar_events.float())


# ---------------------------------------------------------------------------
# RWKV6 block (time-mix + channel-mix)
# ---------------------------------------------------------------------------

def rwkv6_block_init(seed: int, cfg, device) -> dict:
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    assert h * hd == d, "rwkv6: heads * head_dim must equal d_model"
    b = Init(seed, layers.dtype_of(cfg.param_dtype), device)
    b.ones("ln1", (d,))
    b.ones("ln2", (d,))
    # time-mix lerp coefficients (per channel, one per r/k/v/w/g)
    for nm in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
        b.const(nm, (d,), 0.5)
    for nm in ("wr", "wk", "wv", "wg", "wo"):
        b.dense(nm, (d, d))
    # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(x A) B))
    lora = max(32, d // 64)
    b.const("w0", (d,), -0.6)                                 # soft init decay
    b.dense("w_a", (d, lora))
    b.dense("w_b", (lora, d))
    b.const("u", (h, hd), 0.0)                                # bonus
    b.ones("gn", (d,))                                        # group norm gain
    # channel mix
    b.const("mu_ck", (d,), 0.5)
    b.const("mu_cr", (d,), 0.5)
    b.dense("ck", (d, cfg.d_ff))
    b.dense("cv", (cfg.d_ff, d))
    b.dense("cr", (d, d))
    return b.done()


#: The block's matmul weights: each is cast to the compute dtype where it
#: multiplies (``models.transformer.compute_params`` casts them once).
MATMUL_WEIGHTS = ("wr", "wk", "wv", "wg", "wo", "ck", "cv", "cr")


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """Shifted-by-one sequence; position 0 sees ``prev`` (decode carry)."""
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _time_mix_inputs(p, xn, xs):
    mix = lambda mu: xn + (xs - xn) * mu.to(xn.dtype)
    return (mix(p["mu_r"]), mix(p["mu_k"]), mix(p["mu_v"]),
            mix(p["mu_w"]), mix(p["mu_g"]))


def _rwkv_time_mix(p, xn, xs, cfg, state, step: bool):
    """xn, xs (B, T, d) (T == 1 for decode steps)."""
    b, t, _ = xn.shape
    h, hd = cfg.num_heads, cfg.head_dim
    cdt = xn.dtype
    xr, xk, xv, xw, xg = _time_mix_inputs(p, xn, xs)
    r = xr @ p["wr"].to(cdt)
    k = xk @ p["wk"].to(cdt)
    v = xv @ p["wv"].to(cdt)
    g = F.silu(xg @ p["wg"].to(cdt))
    lw_arg = p["w0"].float() + torch.tanh(xw.float() @ p["w_a"].float()) \
        @ p["w_b"].float()
    w = torch.exp(-torch.exp(lw_arg))                        # (…, d) in (0,1)

    n_ev = None
    if step:
        sh = lambda z: z.reshape(b, h, hd)
        ecfg = _decode_engine_cfg(cfg)
        if ecfg is not None:
            o, s_new, n_ev = wkv6_step_gated(sh(r), sh(k), sh(v), sh(w),
                                             p["u"], state, ecfg)
        else:
            o, s_new = wkv6_step(sh(r), sh(k), sh(v), sh(w), p["u"], state)
        o = o.reshape(b, 1, h * hd)
    else:
        sh = lambda z: z.reshape(b, t, h, hd).transpose(1, 2)
        o, s_new = wkv6_chunked(sh(r), sh(k), sh(v), sh(w), p["u"], state,
                                chunk=cfg.wkv_chunk)
        o = o.transpose(1, 2).reshape(b, t, h * hd)
    # per-head group norm (population variance) + gate
    oshape = o.shape
    og = o.reshape(*oshape[:-1], h, hd).float()
    mu = og.mean(-1, keepdim=True)
    var = og.var(-1, keepdim=True, correction=0)
    og = (og - mu) * torch.rsqrt(var + 64e-5)
    o = (og.reshape(oshape) * p["gn"].float()).to(cdt)
    out = (o * g) @ p["wo"].to(cdt)
    return out, s_new, n_ev


def _rwkv_channel_mix(p, xn, xs, cfg):
    cdt = xn.dtype
    xk = xn + (xs - xn) * p["mu_ck"].to(cdt)
    xr = xn + (xs - xn) * p["mu_cr"].to(cdt)
    k = torch.square(F.relu(xk @ p["ck"].to(cdt)))           # relu^2: sparse
    k = layers.mnf_sparsify(k, cfg)                          # MNF exact here
    return torch.sigmoid(xr @ p["cr"].to(cdt)) * (k @ p["cv"].to(cdt))


def rwkv6_block_apply(p, x: torch.Tensor, cfg, wkv_state=None):
    """Prefill.  x (B, T, d).  Returns (y, decode-ready state dict)."""
    xn = layers.rms_norm(x, p["ln1"] - 1.0, cfg.norm_eps)
    xs = _token_shift(xn, None)
    att, s_fin, _ = _rwkv_time_mix(p, xn, xs, cfg, wkv_state, step=False)
    x = x + att
    xn2 = layers.rms_norm(x, p["ln2"] - 1.0, cfg.norm_eps)
    xs2 = _token_shift(xn2, None)
    x = x + _rwkv_channel_mix(p, xn2, xs2, cfg)
    state = dict(shift_att=xn[:, -1], shift_ffn=xn2[:, -1], wkv=s_fin)
    if cfg.mnf.enabled:
        # Decode fills this with the per-token fired-event count; prefill
        # seeds it so the cache keeps one structure.
        state["events"] = torch.zeros((), dtype=torch.float32,
                                      device=x.device)
    return x, state


def rwkv6_block_decode(p, x: torch.Tensor, cfg, state: dict):
    """Decode one token.  x (B, 1, d); ``state`` carries shifts + wkv."""
    xn = layers.rms_norm(x, p["ln1"] - 1.0, cfg.norm_eps)
    xs = state["shift_att"][:, None, :].to(xn.dtype)
    att, s_new, n_ev = _rwkv_time_mix(p, xn, xs, cfg, state["wkv"],
                                      step=True)
    x = x + att
    xn2 = layers.rms_norm(x, p["ln2"] - 1.0, cfg.norm_eps)
    xs2 = state["shift_ffn"][:, None, :].to(xn2.dtype)
    x = x + _rwkv_channel_mix(p, xn2, xs2, cfg)
    new_state = dict(shift_att=xn[:, 0], shift_ffn=xn2[:, 0], wkv=s_new)
    if cfg.mnf.enabled:
        new_state["events"] = n_ev if n_ev is not None else torch.zeros(
            (), dtype=torch.float32, device=x.device)
    return x, new_state


# ---------------------------------------------------------------------------
# Mamba1 (selective SSM) — hymba's parallel-SSM heads
# ---------------------------------------------------------------------------

#: The Mamba leaves each use casts to the compute dtype (the matmul
#: weights, the conv taps and the biases); a_log and d_skip stay f32.
MAMBA_WEIGHTS = ("w_in", "conv_w", "conv_b", "w_bcdt", "w_dt", "dt_bias",
                 "w_out")


def _dt_rank(cfg) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


def mamba_init(seed: int, cfg, d_inner: int | None = None, *,
               device) -> dict:
    ssm = cfg.ssm
    d = cfg.d_model
    di = d_inner or ssm.expand * d
    n = ssm.state_dim
    b = Init(seed, layers.dtype_of(cfg.param_dtype), device)
    b.dense("w_in", (d, 2 * di))                              # x and z
    b.dense("conv_w", (ssm.conv_dim, di), scale=0.5)
    b.zeros("conv_b", (di,))
    b.dense("w_bcdt", (di, 2 * n + _dt_rank(cfg)))
    b.dense("w_dt", (_dt_rank(cfg), di), scale=1.0)
    b.zeros("dt_bias", (di,))
    b.const("a_log", (di, n),
            torch.log(torch.arange(1, n + 1, dtype=torch.float32)))
    b.ones("d_skip", (di,))
    b.dense("w_out", (di, d))
    return b.done()


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no switch to x at a
    threshold (``F.softplus`` has one at 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _mamba_bcdt(p, xc, cfg):
    n = cfg.ssm.state_dim
    bcdt = xc @ p["w_bcdt"].to(xc.dtype)
    bmat = bcdt[..., :n]
    cmat = bcdt[..., n:2 * n]
    dt = _softplus(bcdt[..., 2 * n:] @ p["w_dt"].to(xc.dtype)
                   + p["dt_bias"].to(xc.dtype))                # (.., di)
    return bmat, cmat, dt


def mamba_apply(p, x: torch.Tensor, cfg):
    """Prefill.  x (B, T, d) -> (y (B, T, d), (conv_state, ssm_state)).

    The selective scan runs one step at a time in f32 over chunks of
    ``cfg.ssm.scan_chunk`` steps, one call of :func:`mamba_scan_fused`
    (B10) a chunk, whose final state starts the next chunk: it takes dt,
    x, A, B and C and forms the decay exp(dt A) and increment (dt x) B
    itself (on the card in registers; the plain version on the CPU builds
    the chunk's (B, C, DI, N) streams at once)."""
    ssm = cfg.ssm
    t = x.shape[1]
    cdt = x.dtype
    xz = x @ p["w_in"].to(cdt)
    xc, z = xz.chunk(2, dim=-1)                              # (B, T, di)
    cw = ssm.conv_dim
    assert cw > 1, "conv width must exceed 1"
    # causal depthwise conv, width cw: a sum over taps in the compute dtype
    xpad = F.pad(xc, (0, 0, cw - 1, 0))
    xconv = sum(xpad[:, i:i + t, :] * p["conv_w"][i].to(cdt)
                for i in range(cw)) + p["conv_b"].to(cdt)
    xs = F.silu(xconv)
    bmat, cmat, dt = _mamba_bcdt(p, xs, cfg)
    a = -torch.exp(p["a_log"].float())                       # (di, n)
    h = None                                                 # zeros
    ys = []
    for c0 in range(0, t, ssm.scan_chunk):
        sl = slice(c0, min(c0 + ssm.scan_chunk, t))
        y_c, h = mamba_scan_fused(dt[:, sl], xs[:, sl], a, bmat[:, sl],
                                  cmat[:, sl], h)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)                                 # (B, T, di) f32
    y = y + p["d_skip"].float() * xs.float()
    y = y.to(cdt) * F.silu(z)
    out = y @ p["w_out"].to(cdt)
    conv_state = xpad[:, -(cw - 1):, :]                      # last cw-1 inputs
    return out, (conv_state, h)


def mamba_step(p, x: torch.Tensor, cfg, state):
    """Decode one token.  x (B, 1, d); state = (conv_state (B, cw-1, di),
    ssm_state (B, di, n)).  Returns (out (B, 1, d), (conv_state,
    ssm_state), n_events).

    With MNF on, the state update is fire-gated (DESIGN.md §13): the
    increment gate g = dt·silu(xconv) is thresholded by signed fire and
    the update skips dead channel-blocks (``engine.recurrent_step``,
    kernel B8 on the card); ``n_events`` is its per-token scalar event
    count (0-d f32, zero with MNF off).  The dense path calls the plain
    step (``kernels.mamba_step.ref.mamba_step_ref``) that the gated
    backends run, so at threshold 0 the two agree bit for bit on the
    CPU."""
    from repro_torch.kernels.mamba_step.ref import mamba_step_ref
    conv_state, h = state
    cdt = x.dtype
    f32 = torch.float32
    xz = x[:, 0] @ p["w_in"].to(cdt)
    xc, z = xz.chunk(2, dim=-1)
    win = torch.cat([conv_state, xc[:, None, :]], dim=1)     # (B, cw, di)
    xconv = torch.einsum("bcd,cd->bd", win, p["conv_w"].to(cdt)) \
        + p["conv_b"].to(cdt)
    xs = F.silu(xconv)
    bmat, cmat, dt = _mamba_bcdt(p, xs, cfg)
    a = -torch.exp(p["a_log"].float())
    da = torch.exp(dt.float()[..., None] * a)                # (B, di, n)
    gdrive = dt.float() * xs.float()                         # increment gate
    ecfg = _decode_engine_cfg(cfg)
    if ecfg is not None:
        from repro_torch import engine
        stream = engine.fire_delta(gdrive, ecfg)
        y, h = engine.recurrent_step(
            "mamba", stream, h, ecfg.for_recurrent(gdrive.shape[-1]),
            da=da, bmat=bmat.float(), cmat=cmat.float())
        n_ev = stream.num_scalar_events.float()
    else:
        y, h = mamba_step_ref(gdrive, da, bmat.float(), cmat.float(), h)
        n_ev = torch.zeros((), dtype=f32, device=x.device)
    y = y + p["d_skip"].float() * xs.float()
    y = y.to(cdt) * F.silu(z)
    out = (y @ p["w_out"].to(cdt))[:, None, :]
    return out, (win[:, 1:], h), n_ev
