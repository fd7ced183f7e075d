"""The port's encoder-decoder (whisper-base) and vision-token
(phi-3-vision) models against ``repro`` on the CPU.  The same numpy
inputs — tokens, and audio frames or patch embeddings drawn as normal x
0.02 — and the JAX package's own weights, carried across by
``params_from_numpy`` with the norm gains set off 1, go through both
packages:

- ``layers.layer_norm`` in f32 and bf16; ``attention.attn_apply`` as a
  cross-attention (``kv_override``, causal and not) and as non-causal
  self-attention under a binding window;
- ``_encode_audio`` and ``_cross_kv`` at 1e-4 (f32), with 40 encoder
  frames, so that every attention over them spans 2 KV chunks of 32;
- each reduced config (whisper at 40 frames): a 12-token prefill and 4
  teacher-forced decode steps, logits and every cache leaf (whisper's
  ``cross_k`` / ``cross_v`` too) within 1e-4 of max|JAX| in f32, and in
  bf16 within 3e-2 or JAX's own bf16 noise, as ``tests/
  test_torch_lm_stack.py`` holds the decoders;
- ``input_specs``, ``cache_specs`` and ``count_params`` of the full
  configs against JAX's;
- inside the port: θ = 0 gated bitwise ungated; the encoder runs once in
  a prefill and never in a decode step; a one-token prefill equals the
  port's uncached forward, where JAX's does not (ROADMAP C.r7); a prompt
  shorter than the vision tokens refused; the graphed prefill step on CPU
  tensors bitwise the eager one; the serve driver's stats.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import serve, steps
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm

ARCHS = ("whisper-base", "phi-3-vision-4.2b")
PROMPT, STEPS, B = 12, 4, 2
#: Encoder frames of the reduced whisper: two KV chunks of attn_chunk 32.
FRAMES = 40


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _overrides(arch):
    return dict(enc_frames=FRAMES) if arch == "whisper-base" else {}


def _cfg_pair(arch, **kw):
    kw = {**_overrides(arch), **kw}
    return jget_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def _leaves(tree, path=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", v


def _perturb(tree, names, r_, scale):
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb(v, names, r_, scale)
        elif k in names:
            tree[k] = (v + scale * r_.normal(size=v.shape)).astype(v.dtype)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed=0):
    """The JAX package's reduced weights as numpy, the norm gains set off 1
    (the init leaves them ones, which would leave the ``- 1.0`` offsets
    unexercised)."""
    cfg = jget_config(arch).reduced(**_overrides(arch))
    tree = jax.tree.map(np.array, jtfm.init_params(jax.random.PRNGKey(seed),
                                                   cfg)[0])
    _perturb(tree, ("ln_attn", "ln_mlp", "ln_cross", "final_norm",
                    "enc_final_norm"), np.random.default_rng(seed), 0.1)
    return tree


def _extra_np(cfg, seed=3):
    """The non-token inputs as numpy f32, normal x 0.02."""
    r_ = np.random.default_rng(seed)
    out = {}
    if cfg.encoder_decoder:
        out["audio_frames"] = (0.02 * r_.normal(
            size=(B, cfg.enc_frames, cfg.d_model))).astype(np.float32)
    if cfg.vision_tokens:
        out["vision_embeds"] = (0.02 * r_.normal(
            size=(B, cfg.vision_tokens, cfg.d_model))).astype(np.float32)
    return out


def _jax_extra(extra, cfg):
    return {k: jnp.asarray(v, jnp.dtype(cfg.compute_dtype))
            for k, v in extra.items()}


def _torch_extra(extra, cfg):
    return {k: torch.from_numpy(v).to(tlayers.dtype_of(cfg.compute_dtype))
            for k, v in extra.items()}


def _tparams(arch, cfg):
    return ttfm.compute_params(
        ttfm.params_from_numpy(_jax_params(arch), cfg, "cpu"), cfg)


@functools.lru_cache(maxsize=None)
def _run_both(arch, compute_dtype):
    """JAX's and the port's prefill (step 0) and teacher-forced decode
    steps: a list of (logits, cache) per package."""
    jcfg, tcfg = _cfg_pair(arch, compute_dtype=compute_dtype)
    r_ = np.random.default_rng(7)
    prompt = r_.integers(0, tcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    teach = r_.integers(0, tcfg.vocab_size, (B, STEPS)).astype(np.int32)
    extra = _extra_np(tcfg)
    max_len = PROMPT + STEPS

    jparams = jax.tree.map(jnp.asarray, _jax_params(arch))
    jl, jc = jax.jit(functools.partial(jtfm.prefill, cfg=jcfg,
                                       max_len=max_len))(
        jparams, jnp.asarray(prompt), **_jax_extra(extra, jcfg))
    jsteps = [(np.asarray(jl), jax.tree.map(np.asarray, jc))]
    dstep = jax.jit(functools.partial(jtfm.decode_step, cfg=jcfg))
    for i in range(STEPS):
        jl, jc = dstep(jparams, jc, jnp.asarray(teach[:, i:i + 1]),
                       jnp.asarray(PROMPT + i, jnp.int32))
        jsteps.append((np.asarray(jl), jax.tree.map(np.asarray, jc)))

    tparams = _tparams(arch, tcfg)
    tl, tc = ttfm.prefill(tparams, torch.from_numpy(prompt).long(), tcfg,
                          max_len=max_len, **_torch_extra(extra, tcfg))
    tsteps = [(tl, tc)]
    for i in range(STEPS):
        tl, tc = ttfm.decode_step(tparams, tc,
                                  torch.from_numpy(teach[:, i:i + 1]).long(),
                                  PROMPT + i, tcfg)
        tsteps.append((tl, tc))
    return jsteps, tsteps


def _compare(arch, compute_dtype, tol):
    """Every step's logits and cache leaves within ``tol`` (a number, or
    one per step) of max|JAX|, with JAX's cache structure, shapes and
    dtypes."""
    jsteps, tsteps = _run_both(arch, compute_dtype)
    tols = tol if isinstance(tol, list) else [tol] * len(jsteps)
    worst = {}
    for i, ((jl, jc), (tl, tc)) in enumerate(zip(jsteps, tsteps)):
        assert tuple(tl.shape) == jl.shape and torch.isfinite(tl).all()
        tleaves, jleaves = dict(_leaves(tc)), dict(_leaves(jc))
        assert set(tleaves) == set(jleaves)
        worst[(i, "logits")] = _rel(tl.float().numpy(), jl)
        for name, leaf in tleaves.items():
            want = jleaves[name]
            assert tuple(leaf.shape) == want.shape, name
            assert str(leaf.dtype).split(".")[-1] == str(want.dtype), name
            worst[(i, name)] = _rel(leaf.float().numpy(),
                                    want.astype(np.float32))
    bad = {k: v for k, v in worst.items() if v > tols[k[0]]}
    assert not bad, bad
    return worst


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    r_ = np.random.default_rng(0)
    x = (3.0 + 2.0 * r_.normal(size=(3, 5, 64))).astype(np.float32)
    g = r_.normal(size=(64,)).astype(np.float32)
    b = r_.normal(size=(64,)).astype(np.float32)
    want = jlayers.layer_norm(jnp.asarray(x, dtype), jnp.asarray(g),
                              jnp.asarray(b))
    got = tlayers.layer_norm(torch.from_numpy(x).to(tlayers.dtype_of(dtype)),
                             torch.from_numpy(g), torch.from_numpy(b))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:       # the statistics in f32, one rounding of the result to bf16
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                                   rtol=1e-2)


ATTN_CASES = {
    "cross": dict(kv=True, causal=False, window=None),
    "cross_causal": dict(kv=True, causal=True, window=None),
    "self_noncausal_window": dict(kv=False, causal=False, window=3),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attn_apply_cross_and_noncausal_match_jax(case):
    """``kv_override`` projects nothing for K and V and rotates the query
    only when causal; non-causal self-attention masks |Δ| < window (3
    binds at 10 positions); 40 keys span 2 KV chunks of 32."""
    c = ATTN_CASES[case]
    jcfg, tcfg = _cfg_pair("whisper-base", compute_dtype="float32")
    r_ = np.random.default_rng(11)
    p = {k: (0.1 * r_.normal(size=v.shape)).astype(np.float32)
         for k, v in jattn.attn_init(jax.random.PRNGKey(1), jcfg)[0].items()}
    x = r_.normal(size=(B, 10, tcfg.d_model)).astype(np.float32)
    pos = np.arange(5, 15, dtype=np.int32)
    kw, tkw = {}, {}
    if c["kv"]:
        kv = [r_.normal(size=(B, FRAMES, tcfg.num_kv_heads,
                              tcfg.head_dim)).astype(np.float32)
              for _ in range(2)]
        kw["kv_override"] = tuple(jnp.asarray(a) for a in kv)
        tkw["kv_override"] = tuple(torch.from_numpy(a) for a in kv)
    window = c["window"] or jtfm.GLOBAL_WINDOW
    want, _ = jattn.attn_apply({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), cfg=jcfg,
                               positions=jnp.asarray(pos), window=window,
                               causal=c["causal"], **kw)
    got, _ = tattn.attn_apply({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x), cfg=tcfg,
                              positions=torch.from_numpy(pos), window=window,
                              causal=c["causal"], **tkw)
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-5


def test_attn_apply_cross_writes_no_cache():
    cfg = get_config("whisper-base").reduced()
    p = tattn.attn_init(0, cfg, "cpu")
    x = torch.zeros(1, 2, cfg.d_model)
    kv = torch.zeros(1, 4, cfg.num_kv_heads, cfg.head_dim)
    cache = dict(k=torch.zeros(1, 8, cfg.num_kv_heads, cfg.head_dim),
                 v=torch.zeros(1, 8, cfg.num_kv_heads, cfg.head_dim))
    with pytest.raises(ValueError, match="writes no cache"):
        tattn.attn_apply(p, x, cfg=cfg, positions=torch.arange(2), window=8,
                         cache=cache, decode_pos=0, kv_override=(kv, kv))


# ---------------------------------------------------------------------------
# The encoder
# ---------------------------------------------------------------------------

def test_encode_audio_and_cross_kv_match_jax():
    jcfg, tcfg = _cfg_pair("whisper-base", compute_dtype="float32")
    frames = _extra_np(tcfg)["audio_frames"]
    jparams = jax.tree.map(jnp.asarray, _jax_params("whisper-base"))
    @jax.jit
    def jencode(p, f):
        enc = jtfm._encode_audio(p, f, jcfg)
        return enc, jtfm._cross_kv(p, enc, jcfg)
    jenc, (jk, jv) = jencode(jparams, jnp.asarray(frames))
    tparams = _tparams("whisper-base", tcfg)
    tenc = ttfm._encode_audio(tparams, torch.from_numpy(frames), tcfg)
    tk, tv = ttfm._cross_kv(tparams, tenc, tcfg)
    assert tuple(tenc.shape) == (B, FRAMES, tcfg.d_model)
    assert tuple(tk.shape) == (tcfg.num_layers, B, FRAMES, tcfg.num_kv_heads,
                               tcfg.head_dim) == jk.shape
    assert _rel(tenc.numpy(), np.asarray(jenc)) <= 1e-4
    assert _rel(tk.numpy(), np.asarray(jk)) <= 1e-4
    assert _rel(tv.numpy(), np.asarray(jv)) <= 1e-4


# ---------------------------------------------------------------------------
# The reduced models against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_prefill_and_decode_match_jax_f32(arch):
    """f32 compute: the prefill (whisper's encoder over 40 frames, its
    cross K/V cached; phi-3's first 8 positions its patch embeddings),
    then 4 decode steps; every leaf within 1e-4 of max|JAX|."""
    worst = _compare(arch, "float32", 1e-4)
    if arch == "whisper-base":
        assert (0, "scan/cross_k") in worst and (4, "scan/cross_v") in worst


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_prefill_and_decode_match_jax_bf16(arch):
    """The configs' own bf16: every leaf and the logits within 3e-2 of
    max|JAX bf16| or, at a step where JAX's own bf16 run lies further
    from its f32 run, within that noise."""
    jb, _ = _run_both(arch, "bfloat16")
    jf, _ = _run_both(arch, "float32")
    own = []
    for (bl, bc), (fl, fc) in zip(jb, jf):
        fleaves = dict(_leaves(fc))
        own.append(max([_rel(bl.astype(np.float32), fl)] + [
            _rel(v.astype(np.float32), fleaves[k]) for k, v in _leaves(bc)]))
    worst = _compare(arch, "bfloat16", [max(3e-2, o) for o in own])
    assert max(worst.values()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_text_only_forward_matches_jax(arch):
    """Without its patch embeddings phi-3-vision is a text model, as in
    JAX; whisper's uncached forward runs its encoder on the frames."""
    jcfg, tcfg = _cfg_pair(arch, compute_dtype="float32")
    tokens = np.random.default_rng(5).integers(0, tcfg.vocab_size,
                                               (B, 9)).astype(np.int32)
    extra = {k: v for k, v in _extra_np(tcfg).items() if k == "audio_frames"}
    jparams = jax.tree.map(jnp.asarray, _jax_params(arch))
    jh, _, _ = jtfm.forward(jparams, jnp.asarray(tokens), jcfg,
                            **_jax_extra(extra, jcfg))
    th, cache = ttfm.forward(_tparams(arch, tcfg),
                             torch.from_numpy(tokens).long(), tcfg,
                             **_torch_extra(extra, tcfg))
    assert cache is None
    assert _rel(th.numpy(), np.asarray(jh)) <= 1e-4


# ---------------------------------------------------------------------------
# Specs and counts of the full configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_jax(arch):
    """(shape, dtype) of every input, tokens int64 where JAX's are
    int32."""
    tcfg, jcfg = get_config(arch), jget_config(arch)
    for kind in ("train", "prefill", "decode"):
        want = jtfm.input_specs(jcfg, JShapeConfig("c", 64, 3, kind))
        got = ttfm.input_specs(tcfg, ShapeConfig("c", 64, 3, kind))
        assert set(got) == set(want), kind
        for name, (shape, dtype) in got.items():
            assert shape == want[name].shape, (kind, name)
            jdt = "int64" if want[name].dtype == jnp.int32 \
                else str(want[name].dtype)
            assert str(dtype).split(".")[-1] == jdt, (kind, name)
    assert ("audio_frames" in ttfm.input_specs(
        tcfg, ShapeConfig("c", 64, 3, "prefill"))) == (arch == "whisper-base")


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax(arch):
    tcfg, jcfg = get_config(arch), jget_config(arch)
    want = dict(_leaves(jtfm.cache_specs(jcfg, 4, 48)))
    got = dict(_leaves(ttfm.cache_specs(tcfg, 4, 48)))
    assert set(got) == set(want)
    for name, (shape, dtype) in got.items():
        assert shape == want[name].shape, name
        assert str(dtype).split(".")[-1] == str(want[name].dtype), name
    if arch == "whisper-base":
        assert got["scan/cross_k"][0] == (6, 4, 1500, 8, 64)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_equal_jax(arch):
    want = {"whisper-base": 97_166_336, "phi-3-vision-4.2b": 3_821_079_552}
    assert ttfm.count_params(get_config(arch)) \
        == jtfm.count_params(jget_config(arch)) == want[arch]
    assert ttfm.active_params(get_config(arch)) == want[arch]


def test_every_arch_builds_and_only_moe_ep_raises():
    """Every architecture of the registry builds its reduced params, and
    ``_check_block`` refuses none of them: ``moe_ep``, the last refusal,
    is lifted (``moe.moe_apply_ep``) — its configs build too, and with no
    mesh the MoE forward of a ``moe_ep`` config is bitwise
    ``moe_apply``'s."""
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        ttfm._check_block(cfg)
        ttfm.init_params(0, cfg, "meta")
    for arch in ("deepseek-moe-16b", "deepseek-v2-lite-16b"):
        base = get_config(arch).reduced()
        cfg = dataclasses.replace(base, moe_ep=True)
        ttfm._check_block(cfg)
        params = ttfm.init_params(0, cfg, "cpu")
        tokens = torch.arange(8).reshape(1, 8) % cfg.vocab_size
        assert torch.equal(ttfm.forward(params, tokens, cfg)[0],
                           ttfm.forward(params, tokens, base)[0])


# ---------------------------------------------------------------------------
# Inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_gated_serve_at_zero_threshold_is_bitwise_ungated(arch):
    cfg = get_config(arch).reduced()
    assert cfg.mnf.enabled and cfg.mnf.threshold == 0.0
    off = dataclasses.replace(cfg, mnf=dataclasses.replace(cfg.mnf,
                                                           enabled=False))
    params = ttfm.init_compute_params(0, cfg, "cpu")
    prompts = serve.make_prompts(cfg, B, 10, 0, "cpu")
    extra = serve.make_lm_inputs(cfg, B, 0, "cpu")
    runs = [serve.run_lm(params, c, prompts, 3, keep_logits=True, **extra)
            for c in (cfg, off)]
    for key in ("prefill_logits", "logits", "tokens"):
        assert torch.equal(runs[0][key], runs[1][key]), key


def test_encoder_runs_in_the_prefill_only(monkeypatch):
    """The cross K/V cached by the prefill are bitwise ``_cross_kv`` of a
    separate encoder run on the same frames, and each decode step carries
    them over unchanged without running the encoder."""
    cfg = get_config("whisper-base").reduced()
    params = ttfm.init_compute_params(0, cfg, "cpu")
    frames = serve.make_lm_inputs(cfg, B, 0, "cpu")["audio_frames"]
    want_k, want_v = ttfm._cross_kv(
        params, ttfm._encode_audio(params, frames, cfg), cfg)
    calls = []
    orig = ttfm._encode_audio
    monkeypatch.setattr(ttfm, "_encode_audio",
                        lambda *a: calls.append(1) or orig(*a))
    prompts = serve.make_prompts(cfg, B, 6, 0, "cpu")
    _, cache = ttfm.prefill(params, prompts, cfg, max_len=9,
                            audio_frames=frames)
    assert len(calls) == 1
    assert torch.equal(cache["scan"]["cross_k"], want_k)
    assert torch.equal(cache["scan"]["cross_v"], want_v)
    for i in range(3):
        _, cache = ttfm.decode_step(params, cache, prompts[:, :1], 6 + i, cfg)
    assert len(calls) == 1
    assert torch.equal(cache["scan"]["cross_k"], want_k)
    with pytest.raises(ValueError, match="audio_frames"):
        ttfm.forward(params, prompts, cfg)
    with pytest.raises(ValueError, match="audio_frames"):
        ttfm.prefill(params, prompts, cfg)


def test_one_token_prefill_runs_the_encoder_unlike_jax():
    """ROADMAP C.r7: JAX's forward skips the encoder for any one-token
    input with a cache, so its one-token prefill decodes against zero
    cross K/V and differs from its own uncached forward; the port runs
    the encoder whenever frames are given, and its one-token prefill
    equals its uncached forward."""
    jcfg, tcfg = _cfg_pair("whisper-base", compute_dtype="float32")
    tok = np.array([[3], [7]], np.int32)
    extra = _extra_np(tcfg)
    jparams = jax.tree.map(jnp.asarray, _jax_params("whisper-base"))
    jl, _ = jtfm.prefill(jparams, jnp.asarray(tok), jcfg,
                         **_jax_extra(extra, jcfg))
    jh, _, _ = jtfm.forward(jparams, jnp.asarray(tok), jcfg,
                            **_jax_extra(extra, jcfg))
    jw = jlayers.unembed_matrix(jparams["embed"], jcfg)
    j_uncached = np.asarray(jh[:, -1:] @ jw)
    assert _rel(np.asarray(jl), j_uncached) > 1e-3

    tparams = _tparams("whisper-base", tcfg)
    textra = _torch_extra(extra, tcfg)
    tl, _ = ttfm.prefill(tparams, torch.from_numpy(tok).long(), tcfg,
                         **textra)
    th, _ = ttfm.forward(tparams, torch.from_numpy(tok).long(), tcfg,
                         **textra)
    t_uncached = ttfm.unembed_logits(tparams, th[:, -1:], tcfg)
    assert torch.allclose(tl, t_uncached, atol=1e-6, rtol=1e-6)
    assert _rel(tl.numpy(), j_uncached) <= 1e-4


def test_vision_embeds_fill_the_leading_positions_only():
    cfg = get_config("phi-3-vision-4.2b").reduced()
    params = ttfm.init_compute_params(0, cfg, "cpu")
    tokens = serve.make_prompts(cfg, B, 11, 0, "cpu")
    v1 = serve.make_lm_inputs(cfg, B, 0, "cpu")["vision_embeds"]
    v2 = serve.make_lm_inputs(cfg, B, 1, "cpu")["vision_embeds"]
    e1 = ttfm._embed(params, tokens, cfg, v1)
    e2 = ttfm._embed(params, tokens, cfg, v2)
    nv = cfg.vision_tokens
    assert torch.equal(e1[:, :nv], v1) and torch.equal(e1[:, nv:], e2[:, nv:])
    l1, _ = ttfm.prefill(params, tokens, cfg, vision_embeds=v1)
    l2, _ = ttfm.prefill(params, tokens, cfg, vision_embeds=v2)
    assert not torch.equal(l1, l2)
    with pytest.raises(ValueError, match=r"prompt of 5 tokens.*8 vision"):
        ttfm.prefill(params, tokens[:, :5], cfg, vision_embeds=v1)


@pytest.mark.parametrize("arch", ARCHS)
def test_graphed_prefill_step_on_cpu_is_bitwise_eager(arch):
    """On CPU tensors the graphed prefill step runs the eager prefill with
    the audio or vision input it is handed: bitwise the ungraphed step."""
    cfg = get_config(arch).reduced()
    params = ttfm.init_compute_params(0, cfg, "cpu")
    batch = dict(tokens=serve.make_prompts(cfg, B, 10, 0, "cpu"),
                 **serve.make_lm_inputs(cfg, B, 0, "cpu"))
    shape = ShapeConfig("pf", 14, B, "prefill")
    outs = [steps.make_prefill_step(cfg, shape, graph=g).fn(params, batch)
            for g in (True, False)]
    assert torch.equal(outs[0][0], outs[1][0])
    la = dict(_leaves(outs[0][1]))
    lb = dict(_leaves(outs[1][1]))
    assert set(la) == set(lb) and all(torch.equal(la[k], lb[k]) for k in la)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_reduced_on_cpu_prints_stats(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--gen",
                "3", "--prompt-len", "9", "--batch", "2"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["arch"] == arch and stats["mnf"] is True
    assert stats["generated"] == 3 and stats["device"] == "cpu"
    assert len(stats["sample_tokens"]) == 3


def test_serve_refuses_a_prompt_shorter_than_the_vision_tokens(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--arch", "phi-3-vision-4.2b", "--reduced", "--device",
                    "cpu", "--prompt-len", "7"])
    assert "shorter than the 8 vision tokens" in capsys.readouterr().err
