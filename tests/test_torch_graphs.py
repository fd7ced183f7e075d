"""The port's compiled steps (``repro_torch.launch.graphs``: CUDA graphs in
place of ``jax.jit``) on the CPU, where every entry point runs eagerly as
an explicit CPU caller asks; the graphs themselves replay on the card
(``tests/test_torch_cuda.py``).  The same numpy inputs through both
packages:

- ``make_cnn_forward`` (MINI, MINI_S4; f32 and int8) is bitwise
  ``cnn_forward`` and within the forward tests' 5e-3 of JAX's
  ``make_cnn_forward``;
- ``make_cnn_pipeline`` and ``make_mlp_pipeline`` on CPU tensors are
  bitwise the eager forward, on two inputs, and refuse other parameter
  tensors and other input shapes;
- on the reduced RWKV6, Hymba, DeepSeek-V2-Lite (MLA and the MoE) and
  Gemma-2 (softcaps, alternating windows), ``decode_step`` with a 0-d
  tensor position is bitwise the Python-int one (logits and every cache
  leaf),
  within 1e-4 of JAX's ``decode_step`` in f32, and its in-place cache
  write is bitwise the functional one; ``chunked_attention`` with a tensor
  ``kv_len`` is bitwise the int one;
- ``run_lm`` on the CPU gives the tokens, events and logits of a loop
  over ``decode_step``; the step factories' graphed callables run the
  eager step on CPU tensors;
- ``graphs.capture`` refuses CPU tensors, ``kernels.count_launches``
  counts only inside its block, and nested launch and trace sinks with
  equal contents each leave by identity.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.fire import FireConfig as JFireConfig
from repro.models import cnn as jcnn
from repro.models import transformer as jtfm
from repro_torch import engine, kernels
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.fire import FireConfig
from repro_torch.engine import trace
from repro_torch.launch import graphs, serve, steps
from repro_torch.models import attention as tattn
from repro_torch.models import cnn as tcnn
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttfm

CNN_SPECS = {"mini": (jcnn.MINI, tcnn.MINI),
             "mini_s4": (jcnn.MINI_S4, tcnn.MINI_S4)}


def _image(seed, spec, batch=2):
    size = spec.input_size
    return np.maximum(np.random.default_rng(seed).normal(
        size=(batch, size, size, spec.in_ch)), 0).astype(np.float32)


def _cnn_params(spec, seed=7):
    return [None if p is None else p.numpy() for p in tcnn.init_cnn_params(
        spec, torch.Generator().manual_seed(seed), weight_sparsity=0.5)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", sorted(CNN_SPECS))
def test_make_cnn_forward_bitwise_cnn_forward_and_near_jax(name, int8):
    jspec, tspec = CNN_SPECS[name]
    params = _cnn_params(tspec)
    x = _image(7, tspec)
    fwd = tcnn.make_cnn_forward(
        tspec, fire_cfg=FireConfig(quantize_to_int8=int8))
    tparams = tcnn.params_from_numpy(params)
    y = fwd(tparams, torch.from_numpy(x))
    y_eager = tcnn.cnn_forward(tparams, torch.from_numpy(x), tspec,
                               fire_cfg=FireConfig(quantize_to_int8=int8),
                               device="cpu")
    assert torch.equal(y, y_eager)
    jfwd = jcnn.make_cnn_forward(
        jspec, fire_cfg=JFireConfig(quantize_to_int8=int8))
    yj = np.asarray(jax.jit(jfwd)(params, jnp.asarray(x)))
    np.testing.assert_allclose(y.numpy(), yj, atol=5e-3, rtol=5e-3)


def _pipelines():
    """(label, spec, pipeline factory, eager forward factory, params,
    two inputs) of each network the pipelines serve."""
    out = []
    for name, (_, spec) in sorted(CNN_SPECS.items()):
        params = tcnn.params_from_numpy(_cnn_params(spec))
        xs = [torch.from_numpy(_image(s, spec)) for s in (7, 8)]
        out.append((name, tcnn.make_cnn_pipeline, tcnn.make_cnn_forward,
                    spec, params, xs))
    spec = tmlp.MLP_MINI
    params = tmlp.init_mlp_params(spec, torch.Generator().manual_seed(5),
                                  weight_sparsity=0.5)
    r = np.random.default_rng(2)
    xs = [torch.from_numpy((np.abs(r.normal(size=(4, 64)))
                            * (r.random((4, 64)) > 0.6)).astype(np.float32))
          for _ in range(2)]
    out.append(("mlp_mini", tmlp.make_mlp_pipeline, tmlp.make_mlp_forward,
                spec, params, xs))
    return out


PIPELINES = sorted(CNN_SPECS) + ["mlp_mini"]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", PIPELINES)
def test_pipeline_on_cpu_is_bitwise_the_eager_forward(name, int8):
    _, make_pipe, make_fwd, spec, params, xs = next(
        p for p in _pipelines() if p[0] == name)
    fire_cfg = FireConfig(quantize_to_int8=int8)
    pipe = make_pipe(spec, batch=xs[0].shape[0], fire_cfg=fire_cfg,
                     device="cpu")
    fwd = make_fwd(spec, fire_cfg=fire_cfg)
    for x in xs:
        assert torch.equal(pipe(params, x), fwd(params, x))


@pytest.mark.parametrize("name", PIPELINES)
def test_pipeline_refuses_other_parameter_tensors(name):
    _, make_pipe, _, spec, params, xs = next(
        p for p in _pipelines() if p[0] == name)
    pipe = make_pipe(spec, batch=xs[0].shape[0], device="cpu")
    y = pipe(params, xs[0])
    assert torch.equal(pipe(list(params), xs[0]), y)   # the same tensors
    other = [None if p is None else p.clone() for p in params]
    with pytest.raises(ValueError, match="parameter tensors"):
        pipe(other, xs[0])
    with pytest.raises(ValueError, match="this pipeline takes"):
        pipe(params, xs[0][:1])


# -- the LM steps: the position and the KV length as device tensors ----------

PROMPT, STEPS, B = 12, 2, 2


@functools.lru_cache(maxsize=None)
def _lm(arch):
    """The reduced model in f32 with MNF on (θ = 0) in both packages on the
    JAX package's weights; JAX's prefill and teacher-forced decode
    steps."""
    jcfg = jget_config(arch).reduced(compute_dtype="float32")
    tcfg = get_config(arch).reduced(compute_dtype="float32")
    jcfg = dataclasses.replace(jcfg, mnf=dataclasses.replace(jcfg.mnf,
                                                             enabled=True))
    tcfg = dataclasses.replace(tcfg, mnf=dataclasses.replace(tcfg.mnf,
                                                             enabled=True))
    tree = jax.tree.map(np.array, jtfm.init_params(jax.random.PRNGKey(0),
                                                   jcfg)[0])
    r = np.random.default_rng(3)
    prompt = r.integers(0, tcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    teach = r.integers(0, tcfg.vocab_size, (B, STEPS)).astype(np.int32)
    max_len = PROMPT + STEPS
    jparams = jax.tree.map(jnp.asarray, tree)
    _, jc = jax.jit(functools.partial(jtfm.prefill, cfg=jcfg,
                                      max_len=max_len))(
        jparams, jnp.asarray(prompt))
    dstep = jax.jit(functools.partial(jtfm.decode_step, cfg=jcfg))
    jlogits = []
    for i in range(STEPS):
        jl, jc = dstep(jparams, jc, jnp.asarray(teach[:, i:i + 1]),
                       jnp.asarray(PROMPT + i, jnp.int32))
        jlogits.append(np.asarray(jl))
    tparams = ttfm.compute_params(
        ttfm.params_from_numpy(tree, tcfg, "cpu"), tcfg)
    _, cache = ttfm.prefill(tparams, torch.from_numpy(prompt).long(), tcfg,
                            max_len=max_len)
    return tcfg, tparams, cache, torch.from_numpy(teach).long(), jlogits


def _cache_leaves(cache):
    return dict(zip(_paths(cache), graphs.leaves(cache)))


def _paths(tree, path=""):
    out = []
    for k, v in tree.items():
        out += _paths(v, f"{path}{k}/") if isinstance(v, dict) \
            else [f"{path}{k}"]
    return out


def _clone(cache):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in cache.items()}


LM_ARCHS = ["rwkv6-7b", "hymba-1.5b", "deepseek-v2-lite-16b", "gemma2-27b"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_step_tensor_position_bitwise_int_and_near_jax(arch):
    cfg, params, cache0, teach, jlogits = _lm(arch)
    c_int, c_dev, c_own = cache0, cache0, _clone(cache0)
    for i in range(STEPS):
        tok = teach[:, i:i + 1]
        l_int, c_int = ttfm.decode_step(params, c_int, tok, PROMPT + i, cfg)
        pos = torch.tensor(PROMPT + i)
        l_dev, c_dev = ttfm.decode_step(params, c_dev, tok, pos, cfg)
        l_own, c_own2 = ttfm.decode_step(params, c_own, tok, pos, cfg,
                                         in_place=True)
        assert c_own2 is c_own                 # written in place
        assert torch.equal(l_dev, l_int) and torch.equal(l_own, l_int)
        want = _cache_leaves(c_int)
        for got in (c_dev, c_own):
            leaves = _cache_leaves(got)
            assert set(leaves) == set(want)
            for name, leaf in leaves.items():
                assert torch.equal(leaf, want[name]), (i, name)
        scale = float(np.abs(jlogits[i]).max())
        assert float(np.abs(l_dev.numpy() - jlogits[i]).max()) \
            <= 1e-4 * scale
    # the functional steps left the prefill's cache as it was
    if cfg.block_type != "attn":
        assert torch.equal(_cache_leaves(cache0)["scan/events"],
                           torch.zeros(cfg.num_layers))


@pytest.mark.parametrize("window", [8, 1 << 30])
def test_chunked_attention_tensor_kv_len_bitwise_int(window):
    r = np.random.default_rng(4)
    f = lambda *s: torch.from_numpy(r.normal(size=s).astype(np.float32))
    q, k, v = f(2, 3, 4, 8), f(2, 40, 2, 8), f(2, 40, 2, 8)
    qpos = torch.arange(30, 33, dtype=torch.int32)
    kw = dict(q_positions=qpos, window=window, chunk=16)
    want = tattn.chunked_attention(q, k, v, kv_len=33, **kw)
    got = tattn.chunked_attention(q, k, v, kv_len=torch.tensor(33), **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_run_lm_on_cpu_equals_a_loop_over_decode_step(arch):
    cfg = serve.lm_config(arch, reduced=True, mnf=True)
    params = ttfm.compute_params(ttfm.init_params(0, cfg, "cpu"), cfg)
    prompts = serve.make_prompts(cfg, B, 5, 0, "cpu")
    run = serve.run_lm(params, cfg, prompts, 3, keep_logits=True)
    assert run["launches"] is None and run["capture_s"] == 0.0
    logits, cache = ttfm.prefill(params, prompts, cfg, max_len=8)
    assert torch.equal(run["prefill_logits"], logits)
    tok = logits[:, -1].argmax(-1)[:, None]
    for i in range(3):
        logits, cache = ttfm.decode_step(params, cache, tok, 5 + i, cfg)
        assert torch.equal(run["inputs"][:, i:i + 1], tok)
        tok = logits[:, -1].argmax(-1)[:, None]
        assert torch.equal(run["tokens"][:, i:i + 1], tok)
        assert torch.equal(run["logits"][i], logits[:, -1])
        if run["events"] is not None:
            assert torch.equal(run["events"][i], cache["scan"]["events"])
    assert (run["events"] is None) == (cfg.block_type == "attn")


def test_graphed_step_factories_run_the_eager_step_on_cpu_tensors():
    cfg, params, cache, teach, _ = _lm("rwkv6-7b")
    tok = teach[:, :1]
    srv = steps.make_serve_step(cfg, ShapeConfig("s", PROMPT + STEPS, B,
                                                 "decode"))
    assert srv.fn.position is None
    got = srv.fn(params, cache, dict(tokens=tok), torch.tensor(PROMPT))
    want = ttfm.decode_step(params, cache, tok, PROMPT, cfg)
    assert torch.equal(got[0], want[0])
    prompt = teach.repeat(1, 3)
    pre = steps.make_prefill_step(cfg, ShapeConfig("p", 6, B, "prefill"))
    got = pre.fn(params, dict(tokens=prompt))
    want = ttfm.prefill(params, prompt, cfg, max_len=6)
    assert torch.equal(got[0], want[0])
    # off the CPU the graphed step takes its position as a device tensor
    meta = torch.zeros((B, 1), dtype=torch.int64, device="meta")
    with pytest.raises(TypeError, match="0-d integer tensor"):
        srv.fn(params, cache, dict(tokens=meta), PROMPT)


def test_capture_refuses_cpu_tensors_and_launches_count_inside_only():
    with pytest.raises(ValueError, match="CUDA tensors only"):
        graphs.capture(lambda x: x + 1, torch.zeros(3))

    def wrapper():
        pass
    wrapper.launches, wrapper.capture = 0, None
    kernels.note_launch(wrapper, (), {})
    with kernels.count_launches() as seen:
        kernels.note_launch(wrapper, (), {})
        kernels.note_launch(wrapper, (), {})
    kernels.note_launch(wrapper, (), {})
    assert seen == {wrapper: 2} and wrapper.launches == 4
    # nested sinks with equal contents: each leaves by identity
    with kernels.count_launches() as outer, engine.trace_dispatch() as recs:
        with kernels.count_launches() as inner, \
                engine.trace_dispatch() as inner_recs:
            pass
        kernels.note_launch(wrapper, (), {})
        trace.record(op="x")
    assert outer == {wrapper: 1} and inner == {} and inner_recs == []
    assert recs == [{"op": "x"}]
    a = [torch.zeros(2), None, {"w": torch.ones(3)}]
    assert graphs.same_tensors(a, list(a))
    assert not graphs.same_tensors(a, [torch.zeros(2), None,
                                       {"w": a[2]["w"]}])
