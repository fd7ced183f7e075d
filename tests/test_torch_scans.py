"""The prefill scans of the port against ``repro`` on the CPU: the same numpy
inputs through both packages.

- B9 (single-head WKV6) and B9' (multi-head): the port's plain versions,
  reached through the counting wrappers, against ``wkv6_ref``,
  ``wkv6_pallas(interpret=True)`` and ``wkv6(interpret=True)`` at 1e-5,
  with a non-zero initial state and at a T that is not a whole number of
  the JAX wrapper's chunks (the port does not pad: w = 1 padding leaves S
  unchanged, so the two agree); B9' also on the prefill's layout (bf16 r,
  k, v and f32 w, (B, H, T, D) views of (B, T, H, D)) against JAX on the
  same values in f32.  Off the CPU both wrappers hand the launcher the
  caller's own tensors (meta tensors, a stub launcher): no copy but the
  f32 cast of another float type.
- B10 (selective scan): the plain version against ``mamba_scan_ref`` and
  ``mamba_scan(interpret=True)`` at 1e-5, at a ragged T and a DI that is
  not a whole number of the JAX wrapper's ``d_blk``.
- B10's fused entry (dt, x, A, B, C): its plain version bitwise the scan
  of the streams the Mamba prefill built inline, and within 1e-5 of JAX's
  ``mamba_scan_ref`` on streams built alike (f32 and bf16, h0 None and
  given).
- The launchers refuse CPU tensors; a CPU call counts no launch.
- ``mamba_apply`` over three scan chunks (the last ragged) against JAX's
  at 1e-4, bitwise the sequential loop it ran before B10 took its scan,
  and the reduced Hymba prefill calls B10's fused entry ``layers x
  ceil(T / chunk)`` times.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.mamba_scan import mamba_scan as j_mamba_scan
from repro.kernels.mamba_scan import mamba_scan_ref as j_mamba_scan_ref
from repro.kernels.wkv6 import wkv6 as j_wkv6
from repro.kernels.wkv6 import wkv6_ref as j_wkv6_ref
from repro.kernels.wkv6.kernel import wkv6_pallas
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.kernels.mamba_scan.kernel import (mamba_scan_cuda,
                                                   mamba_scan_fused_cuda)
from repro_torch.kernels.mamba_scan.ops import mamba_scan, mamba_scan_fused
from repro_torch.kernels.mamba_scan.ref import (mamba_scan_ref,
                                                mamba_scan_streams)
from repro_torch.kernels.wkv6.kernel import wkv6_cuda
from repro_torch.kernels.wkv6.ops import wkv6, wkv6_single
from repro_torch.kernels.wkv6.ref import wkv6_multihead_ref, wkv6_ref
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def _wkv6_inputs(seed, shape, heads_shape):
    """r, k, v (normal), w in (0.3, 1), u and s0 (normal) as f32 numpy."""
    r_ = np.random.default_rng(seed)
    f = lambda *s: r_.normal(size=s).astype(np.float32)
    d = shape[-1]
    w = r_.uniform(0.3, 1.0, size=shape).astype(np.float32)
    s0 = f(*shape[:-2], d, d)
    return f(*shape), f(*shape), f(*shape), w, f(*heads_shape), s0


def test_b9_plain_matches_jax_ref_and_pallas():
    """B9, one head per row: B 2, T 8 (two chunks of 4), D 16, non-zero
    s0; o and S within 1e-5 of JAX's oracle and of its Pallas kernel."""
    r, k, v, w, u, s0 = _wkv6_inputs(9, (2, 8, 16), (16,))
    jargs = [jnp.asarray(a) for a in (r, k, v, w, u, s0)]
    want = [j_wkv6_ref(*jargs), wkv6_pallas(*jargs, chunk=4, interpret=True)]
    targs = [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]
    launches = wkv6_single.launches
    o, s = wkv6_single(*targs)
    assert wkv6_single.launches == launches       # the CPU path counts none
    o2, s2 = wkv6_ref(*targs)
    assert torch.equal(o, o2) and torch.equal(s, s2)
    assert tuple(o.shape) == (2, 8, 16) and tuple(s.shape) == (2, 16, 16)
    for wo, ws in want:
        _close(o, wo)
        _close(s, ws)


@pytest.mark.parametrize("with_s0", [False, True])
def test_b9_multihead_plain_matches_jax_wkv6(with_s0):
    """B9', H 3, T 13 against JAX's chunk 4 (which pads T to 16 with
    w = 1 and zero r, k, v), s0 None and given; 1e-5."""
    r, k, v, w, u, s0 = _wkv6_inputs(13 + with_s0, (2, 3, 13, 8), (3, 8))
    s0 = s0 if with_s0 else None
    jargs = [None if a is None else jnp.asarray(a)
             for a in (r, k, v, w, u, s0)]
    wo, ws = j_wkv6(*jargs, chunk=4, interpret=True)
    targs = [None if a is None else torch.from_numpy(a)
             for a in (r, k, v, w, u, s0)]
    o, s = wkv6(*targs)
    o2, s2 = wkv6_multihead_ref(*targs)
    assert torch.equal(o, o2) and torch.equal(s, s2)
    assert tuple(o.shape) == (2, 3, 13, 8) and tuple(s.shape) == (2, 3, 8, 8)
    _close(o, wo)
    _close(s, ws)
    # each head is the single-head op on its rows with its own bonus row
    for h in range(3):
        oh, sh = wkv6_single(*(t[:, h] for t in targs[:4]), targs[4][h],
                             None if s0 is None else targs[5][:, h])
        assert torch.equal(oh, o[:, h]) and torch.equal(sh, s[:, h])


def _prefill_layout(x, dtype):
    """(B, H, T, D) numpy as the RWKV6 prefill hands it to the WKV: a
    (B, H, T, D) view (``transpose(1, 2)``) of a (B, T, H, D) tensor."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                            ).to(dtype).transpose(1, 2)


@pytest.mark.parametrize("with_s0", [False, True])
def test_b9_multihead_on_the_prefill_layout_matches_jax_wkv6(with_s0):
    """B9' as the prefill hands it its inputs: bf16 r, k, v and f32 w,
    each a (B, H, T, D) view of a (B, T, H, D) tensor (strided, not
    contiguous), against JAX's ``wkv6(interpret=True)`` on the same values
    in f32 (bf16 -> f32 is exact) at 1e-5; T 11 against JAX's chunk 4."""
    r, k, v, w, u, s0 = _wkv6_inputs(21 + with_s0, (2, 3, 11, 8), (3, 8))
    s0 = s0 if with_s0 else None
    rows = [_prefill_layout(x, torch.bfloat16) for x in (r, k, v)] \
        + [_prefill_layout(w, torch.float32)]
    assert not any(x.is_contiguous() for x in rows)
    assert [x.dtype for x in rows] == [torch.bfloat16] * 3 + [torch.float32]
    targs = rows + [torch.from_numpy(u),
                    None if s0 is None else torch.from_numpy(s0)]
    jargs = [None if a is None else jnp.asarray(a.float().numpy())
             for a in targs]
    wo, ws = j_wkv6(*jargs, chunk=4, interpret=True)
    o, s = wkv6(*targs)
    assert o.dtype == s.dtype == torch.float32
    assert tuple(o.shape) == (2, 3, 11, 8) and tuple(s.shape) == (2, 3, 8, 8)
    _close(o, wo)
    _close(s, ws)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("single", [False, True])
def test_b9_wrappers_hand_the_launcher_the_callers_tensors(monkeypatch,
                                                           dtype, single):
    """Off the CPU, ``wkv6`` and ``wkv6_single`` hand the launcher the
    caller's own r, k, v and w (the same objects: the prefill's bf16 (B,
    T, H, D).transpose(1, 2) views and its f32 w, no ``.float()`` and no
    ``.contiguous()`` copy), u and s0 as they are where f32 and
    contiguous, and count one launch; rows of another float type (f16)
    reach it cast to f32.  Meta tensors stand in for the card's; the
    launcher is a stub."""
    from repro_torch.kernels.wkv6 import ops
    calls = []

    def kernel(*args):
        calls.append(args)
        r = args[0]
        return (torch.empty(r.shape, device="meta"),
                torch.empty((*r.shape[:-2], r.shape[-1], r.shape[-1]),
                            device="meta"))

    monkeypatch.setattr(ops, "wkv6_cuda", kernel)
    b, t, h, d = 2, 5, 3, 8

    def view(dt):
        x = torch.empty((b, t, h, d), dtype=dt, device="meta").transpose(1, 2)
        return x[:, 0] if single else x

    rows = [view(dtype) for _ in range(3)] + [view(torch.float32)]
    u = torch.empty((d,) if single else (h, d), device="meta")
    s0 = torch.empty((b, d, d) if single else (b, h, d, d), device="meta")
    wrapper = ops.wkv6_single if single else ops.wkv6
    launches = wrapper.launches
    o, s = wrapper(*rows, u, s0)
    assert wrapper.launches == launches + 1
    (args,) = calls
    assert len(args) == 6 and args[4] is u and args[5] is s0
    assert args[3] is rows[3]
    for got, x in zip(args[:3], rows[:3]):
        if dtype == torch.bfloat16:
            assert got is x
        else:
            assert got.dtype == torch.float32 and got.shape == x.shape
    assert o.shape == rows[0].shape
    assert s.shape == (*rows[0].shape[:-2], d, d)


def _scan_inputs(seed, b, t, di, n):
    r_ = np.random.default_rng(seed)
    da = np.exp(-r_.uniform(0.01, 2.0, size=(b, t, di, n))).astype(np.float32)
    f = lambda *s: r_.normal(size=s).astype(np.float32)
    return da, f(b, t, di, n), f(b, t, n), f(b, di, n)


@pytest.mark.parametrize("with_h0", [False, True])
def test_b10_plain_matches_jax_ref_and_pallas(with_h0):
    """B10 at T 13 (JAX's chunk 4 pads it to 16 with da = 1, dbx = 0) and
    DI 40 (its d_blk 16 pads it to 48 with zeros), N 4, h0 None and
    given; y and h within 1e-5 of JAX's oracle and its Pallas kernel."""
    da, dbx, c, h0 = _scan_inputs(40 + with_h0, 2, 13, 40, 4)
    h0 = h0 if with_h0 else None
    jargs = [None if a is None else jnp.asarray(a) for a in (da, dbx, c, h0)]
    want = [j_mamba_scan_ref(*jargs),
            j_mamba_scan(*jargs, d_blk=16, chunk=4, interpret=True)]
    targs = [None if a is None else torch.from_numpy(a)
             for a in (da, dbx, c, h0)]
    launches = mamba_scan.launches
    y, h = mamba_scan(*targs)
    assert mamba_scan.launches == launches
    y2, h2 = mamba_scan_ref(*targs)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert tuple(y.shape) == (2, 13, 40) and tuple(h.shape) == (2, 40, 4)
    for wy, wh in want:
        _close(y, wy)
        _close(h, wh)


@pytest.mark.parametrize("launcher", ["wkv6", "mamba_scan",
                                      "mamba_scan_fused"])
def test_scan_launchers_refuse_cpu_tensors(launcher):
    z = torch.zeros
    with pytest.raises(ValueError, match="CUDA tensors only"):
        if launcher == "wkv6":
            wkv6_cuda(*(z((2, 3, 4)) for _ in range(4)), z((4,)), None)
        elif launcher == "mamba_scan":
            mamba_scan_cuda(z((1, 3, 4, 2)), z((1, 3, 4, 2)), z((1, 3, 2)),
                            None)
        else:
            mamba_scan_fused_cuda(z((1, 3, 4)), z((1, 3, 4)), z((4, 2)),
                                  z((1, 3, 2)), z((1, 3, 2)), None)


def _fused_inputs(seed, b, t, di, n):
    """dt (softplus of a normal), x, B, C (normal), A = -exp(log 1..n) as
    the Mamba init makes it, h0 (normal); f32 numpy."""
    r_ = np.random.default_rng(seed)
    f = lambda *s: r_.normal(size=s).astype(np.float32)
    dt = np.log1p(np.exp(f(b, t, di))).astype(np.float32)
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (di, 1))
    return dt, f(b, t, di), a, f(b, t, n), f(b, t, n), f(b, di, n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_b10_fused_plain_is_the_scan_of_the_prefills_streams(dtype,
                                                             with_h0):
    """The fused entry's plain version, T 13, DI 40, N 4: bitwise
    ``mamba_scan_ref`` on the streams built as the Mamba prefill built
    them inline (da = exp(dt A), dbx = (dt x) B, from the f32 casts of dt,
    x, B, C), and within 1e-5 of JAX's ``mamba_scan_ref`` on streams built
    alike in jnp from the same values.  dt, x, B and C are sliced along T
    as the prefill slices a chunk; bf16 ones are rounded first (both
    packages then see the same f32 values).  A CPU call counts no
    launch."""
    dt, x, a, bm, cm, h0 = _fused_inputs(13 + with_h0, 2, 20, 40, 4)
    tdt = getattr(torch, dtype)
    full = [torch.from_numpy(v).to(tdt) for v in (dt, x, bm, cm)]
    dt_t, x_t, b_t, c_t = (v[:, 4:17] for v in full)     # a chunk of 13
    a_t = torch.from_numpy(a)
    h0_t = torch.from_numpy(h0) if with_h0 else None
    launches = mamba_scan_fused.launches
    y, h = mamba_scan_fused(dt_t, x_t, a_t, b_t, c_t, h0_t)
    assert mamba_scan_fused.launches == launches
    assert tuple(y.shape) == (2, 13, 40) and tuple(h.shape) == (2, 40, 4)
    assert y.dtype == h.dtype == torch.float32
    dt_c = dt_t.float()
    da = torch.exp(dt_c[..., None] * a_t)
    dbx = (dt_c * x_t.float())[..., None] * b_t.float()[..., None, :]
    y2, h2 = mamba_scan_ref(da, dbx, c_t.float(), h0_t)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert all(torch.equal(u, v) for u, v in zip(
        mamba_scan_streams(dt_t, x_t, a_t, b_t, c_t), (da, dbx, c_t.float())))
    jdt, jx, jb, jc = (jnp.asarray(v.float().numpy())
                       for v in (dt_t, x_t, b_t, c_t))
    jda = jnp.exp(jdt[..., None] * jnp.asarray(a))
    jdbx = (jdt * jx)[..., None] * jb[..., None, :]
    wy, wh = j_mamba_scan_ref(jda, jdbx, jc,
                              None if h0_t is None else jnp.asarray(h0))
    _close(y, wy)
    _close(h, wh)


# ---------------------------------------------------------------------------
# mamba_apply: the prefill's scan through B10
# ---------------------------------------------------------------------------

T_APPLY, CHUNK = 20, 8


def _cfg_pair():
    """The reduced Hymba config of both packages at scan chunk 8."""
    return [dataclasses.replace(c, ssm=dataclasses.replace(
        c.ssm, scan_chunk=CHUNK)) for c in (
            jget_config("hymba-1.5b").reduced(compute_dtype="float32"),
            get_config("hymba-1.5b").reduced(compute_dtype="float32"))]


def _mamba_params(cfg, seed=5):
    """The JAX package's Mamba weights as numpy, with non-zero conv and dt
    biases (init leaves them zero)."""
    p = jax.tree.map(np.array, jssm.mamba_init(
        jax.random.PRNGKey(seed), cfg, d_inner=cfg.d_model)[0])
    r_ = np.random.default_rng(seed)
    for name in ("conv_b", "dt_bias"):
        p[name] = (0.1 * r_.normal(size=p[name].shape)).astype(np.float32)
    return p


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_mamba_apply_chunked_matches_jax():
    """T 20 at scan chunk 8: three B10 calls (8, 8 and a ragged 4) with h
    carried across, against JAX's chunked associative scan at 1e-4 (the
    two sum in other orders); the conv state exactly."""
    jcfg, tcfg = _cfg_pair()
    p = _mamba_params(jcfg)
    x = np.random.default_rng(20).normal(size=(2, T_APPLY, 64)).astype(
        np.float32)
    jy, (jconv, jh) = jssm.mamba_apply(jax.tree.map(jnp.asarray, p),
                                       jnp.asarray(x), jcfg)
    ty, (tconv, th) = tssm.mamba_apply(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        tcfg)
    assert _rel(ty.numpy(), jy) <= 1e-4
    assert _rel(th.numpy(), jh) <= 1e-4
    np.testing.assert_array_equal(tconv.numpy(), np.asarray(jconv))


def test_mamba_apply_bitwise_the_sequential_loop():
    """On the CPU B10 is the sequential loop the prefill ran inline before
    (h = da h + dbx, y = sum h c, h carried across chunks): mamba_apply's
    y and h equal it bit for bit."""
    _, cfg = _cfg_pair()
    p = {k: torch.from_numpy(v) for k, v in _mamba_params(cfg, 7).items()}
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(2, T_APPLY, 64)).astype(np.float32))
    out, (_, h_fin) = tssm.mamba_apply(p, x, cfg)
    # the inputs of the scan, built as mamba_apply builds them
    xz = x @ p["w_in"]
    xc, z = xz.chunk(2, dim=-1)
    cw = cfg.ssm.conv_dim
    xpad = torch.nn.functional.pad(xc, (0, 0, cw - 1, 0))
    xs = torch.nn.functional.silu(
        sum(xpad[:, i:i + T_APPLY, :] * p["conv_w"][i] for i in range(cw))
        + p["conv_b"])
    bmat, cmat, dt = tssm._mamba_bcdt(p, xs, cfg)
    a = -torch.exp(p["a_log"])
    h = torch.zeros(h_fin.shape)
    ys = []
    for c0 in range(0, T_APPLY, CHUNK):
        sl = slice(c0, min(c0 + CHUNK, T_APPLY))
        da = torch.exp(dt[:, sl][..., None] * a)
        dbx = (dt[:, sl] * xs[:, sl])[..., None] * bmat[:, sl][..., None, :]
        for i in range(da.shape[1]):
            h = da[:, i] * h + dbx[:, i]
            ys.append((h * cmat[:, sl][:, i, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) + p["d_skip"] * xs
    want = (y * torch.nn.functional.silu(z)) @ p["w_out"]
    assert torch.equal(h_fin, h)
    assert torch.equal(out, want)


@pytest.mark.parametrize("prompt_len", [T_APPLY, CHUNK])
def test_reduced_hymba_prefill_calls_b10_per_layer_and_chunk(monkeypatch,
                                                             prompt_len):
    """A spy on ``mamba_scan_fused`` in the Mamba module: the reduced
    Hymba's prefill (2 layers, scan chunk 8) calls it layers x ceil(T / 8)
    times, each chunk's first call with h0 None and the rest with the
    previous call's final state."""
    _, cfg = _cfg_pair()
    calls = []

    def spy(dt, x, a, bmat, cmat, h0=None):
        out = mamba_scan_fused(dt, x, a, bmat, cmat, h0)
        calls.append((dt.shape[1], h0, out[1]))
        return out

    monkeypatch.setattr(tssm, "mamba_scan_fused", spy)
    params = ttfm.compute_params(ttfm.init_params(0, cfg, "cpu"), cfg)
    tokens = torch.from_numpy(np.random.default_rng(prompt_len).integers(
        0, cfg.vocab_size, (2, prompt_len)))
    logits, _ = ttfm.prefill(params, tokens, cfg)
    per_layer = math.ceil(prompt_len / CHUNK)
    assert len(calls) == cfg.num_layers * per_layer
    assert bool(torch.isfinite(logits).all())
    for layer in range(cfg.num_layers):
        mine = calls[layer * per_layer:(layer + 1) * per_layer]
        assert [t for t, _, _ in mine] == [
            min(CHUNK, prompt_len - c0) for c0 in range(0, prompt_len, CHUNK)]
        assert mine[0][1] is None
        assert all(h0 is prev[2] for (_, h0, _), prev in zip(mine[1:], mine))
