"""Serving driver: an LM prefill + greedy decode loop, or the event-resident
CNN/MLP serving tier — port of ``repro.launch.serve``::

    python -m repro_torch.launch.serve --arch rwkv6-7b --mnf
    python -m repro_torch.launch.serve --arch gemma2-27b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --reduced --device cpu --mnf

LM mode serves every architecture of ``configs.ARCH_IDS``.  Weights are
random from ``--seed``, drawn in f32 (the configs' param dtype) one
module at a time, the leaves a block casts cast to the compute dtype as
they are made (``transformer.init_compute_params``: the f32 model is
never held whole); prompts are random tokens from the same seed, and
whisper-base's audio frames and phi-3-vision's patch embeddings normal
x 0.02 from it (``make_lm_inputs``; phi-3-vision refuses a
``--prompt-len`` below its 144 vision tokens).  With
MNF on (``--mnf`` or a non-zero ``--mnf-threshold``; every config has it
on at θ = 0) each FFN fires between its up and down projections
(``engine.sparsify``, plain torch), and every decode step of RWKV6 and
Hymba runs the fire-gated state update (B7 for RWKV6, B8 for Hymba's
Mamba heads, on the card) and reports its fired events; Hymba's prefill
runs its selective scan through B10 on the card either way.  On the card
the prefill and the decode step run as CUDA graphs (``launch.steps``),
captured before the timed runs.  Prints one
stats JSON line: ``prefill_s`` and ``decode_tok_per_s`` (warm replays),
``capture_s``, ``events_per_token`` with its min and max,
``events_per_layer``.  The prompt is ``--prompt-len`` tokens.  (The JAX
driver prefills ``prompt-len + gen`` tokens under the same flag;
ROADMAP.md queue C.)

CNN mode (``--cnn`` or ``--mlp``) runs a serving replica
(``repro_torch.serving``, DESIGN.md §10): a FIFO request queue
continuously batched into padded buckets, one CUDA graph per bucket
captured at startup.  MNF is the default; ``--dense`` serves the oracle
path instead.  Requests are relu(normal) images (or vectors) made from
``--seed`` ahead of the loop, ``--rate`` a tick for ``--ticks`` ticks::

    python -m repro_torch.launch.serve --cnn vgg16 --cnn-size 224 \
        --rate 32 --ticks 4
    PYTHONPATH=src python -m repro_torch.launch.serve --mlp mini \
        --device cpu

``--route adaptive`` routes each boundary by the argmin of its event and
dense costs at ``--occupancy-hint``: this module loads the crossover table
of ``--bench`` (default ``BENCH_engine.json``) and installs it with
``costmodel.crossover.set_active_table`` (the engine reads no file on its
own), and the stats JSON names the table's ``device`` and entry count.
``BENCH_engine.json``'s entries are the JAX package's CPU interpret-mode
times (``"device": "cpu"``), not an H100 calibration::

    python -m repro_torch.launch.serve --cnn alexnet --cnn-size 224 \
        --route adaptive --occupancy-hint 0.3 --bench BENCH_engine.json

Meshes, as in ``repro.launch.serve``: the CNN mode serves on
``launch.mesh.make_serve_mesh()`` (every rank on the data axis: each
bucket batch-parallel over it), the LM mode on ``checked_mesh((world,
1))`` (the sharded eager steps of ``launch.steps``).  Started by
``torchrun --nproc-per-node N`` (N > 1) every rank serves the same
requests; a single process is a world of one, whose 1x1 mesh places
everything whole on the one device, so it serves with no mesh (the CUDA
graphs as above) and starts no process group.

``--smoke`` serves the mini networks through buckets (1, 2, 4) and fails
(exit 1) on a steady-state capture, an eligible boundary reporting
fallback_decode, padded-bucket logits that are not bitwise the unpadded
forward's, a re-captured replica whose routes differ, or an MLP densify
or re-tile point::

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Left out of CNN mode: ``--cache-dir`` (a CUDA graph cannot be written to
disk, and the kernel library is already cached per source hash:
``repro_torch.serving``) and ``--mnf-pallas`` (there is no Pallas
backend: the device picks ``cuda`` or ``block``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import default_device
from repro_torch.launch import steps
from repro_torch.launch.mesh import checked_mesh, make_serve_mesh
from repro_torch.parallel.sharding import whole
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import dtype_of

__all__ = ["lm_config", "main", "make_lm_inputs", "make_prompts",
           "make_requests", "run_lm", "serve_arrivals", "serve_cnn",
           "serve_lm", "serve_smoke"]


def lm_config(arch: str, *, reduced: bool = False, mnf: bool = False,
              threshold: float = 0.0):
    """The served config: ``--mnf-threshold`` implies ``--mnf`` (a
    sub-flag alone must not silently serve the dense path)."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if mnf or threshold != 0.0:
        cfg = dataclasses.replace(
            cfg, mnf=dataclasses.replace(cfg.mnf, enabled=True,
                                         threshold=threshold))
    return cfg


def make_prompts(cfg, batch: int, prompt_len: int, seed: int,
                 device) -> torch.Tensor:
    """(batch, prompt_len) int64 random tokens from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=g, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_lm_inputs(cfg, batch: int, seed: int, device) -> dict:
    """The non-token inputs a config takes, seeded from ``seed`` as normal
    x 0.02 in the compute dtype (as the JAX package's architecture smoke
    tests make them): whisper's ``audio_frames`` (batch, enc_frames, d)
    and phi-3-vision's ``vision_embeds`` (batch, vision_tokens, d); empty
    for the others.  (The JAX package's ``launch.serve`` feeds zeros,
    which would leave whisper's encoder only its position encoding to
    see.)"""
    cdt = dtype_of(cfg.compute_dtype)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    out = {}
    if cfg.encoder_decoder:
        out["audio_frames"] = (torch.randn(
            (batch, cfg.enc_frames, cfg.d_model), generator=g,
            device=device) * 0.02).to(cdt)
    if cfg.vision_tokens:
        out["vision_embeds"] = (torch.randn(
            (batch, cfg.vision_tokens, cfg.d_model), generator=g,
            device=device) * 0.02).to(cdt)
    return out


def _world_mesh(shape_of_world, device: torch.device):
    """The serving mesh for this world, or None in a world of one
    (module docstring)."""
    from repro_torch.launch.mesh import init_world
    world = init_world(device.type)
    return None if world == 1 else shape_of_world(world, device)


def run_lm(params, cfg, prompts: torch.Tensor, gen: int, *,
           audio_frames: torch.Tensor | None = None,
           vision_embeds: torch.Tensor | None = None,
           teacher: torch.Tensor | None = None, keep_logits: bool = False,
           graph: bool = True, mesh=None) -> dict:
    """Prefill ``prompts`` (B, P) — with whisper's ``audio_frames`` or
    phi-3-vision's ``vision_embeds`` where the config takes them — then
    ``gen`` greedy decode steps (an encoder-decoder's read the cross K/V
    its prefill cached).

    Each step feeds the previous step's argmax (the first the prefill's),
    or with ``teacher`` (B, gen) its column i.  On the card the prefill
    and the decode step are CUDA graphs (``launch.steps``; ``graph=False``
    runs them eagerly), captured first into one memory pool; the position
    stays on the device and advances in the decode graph, and the decode
    loop makes no host sync (``torch.cuda.set_sync_debug_mode("error")``
    holds it so).  Returns ``tokens`` (B, gen) (each step's argmax),
    ``inputs`` (B, gen) (what each step was fed), ``events`` (gen, L)
    per-layer fired events or None (MNF off), ``logits`` (gen, B, V) when
    ``keep_logits``, ``prefill_logits``, the final ``cache`` (on the card
    the decode graph's own), ``prefill_s`` and ``decode_s`` (host clock,
    ending in a synchronize; warm replays on the card),
    ``capture_s`` (the graphs' warm-up and capture) and ``launches``
    ({kernel wrapper: launches}, captured × replayed; None when eager).
    With a ``mesh`` the steps are the sharded eager ones (no graphs, no
    sync guard; the final cache a tree of DTensors).
    """
    bsz, plen = prompts.shape
    dev = prompts.device
    max_len = plen + gen
    graph = graph and dev.type == "cuda" and mesh is None
    pool = torch.cuda.graph_pool_handle() if graph else None
    pre = steps.make_prefill_step(cfg, ShapeConfig("pf", max_len, bsz,
                                                   "prefill"),
                                  graph=graph, pool=pool, mesh=mesh)
    srv = steps.make_serve_step(cfg, ShapeConfig("serve", max_len, bsz,
                                                 "decode"),
                                graph=graph, pool=pool, mesh=mesh)
    captured = [pre.fn.capture(params, prompts, audio_frames, vision_embeds),
                srv.fn.capture(params, dev)] if graph else []
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = pre.fn(params, dict(tokens=prompts,
                                        audio_frames=audio_frames,
                                        vision_embeds=vision_embeds))
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits.clone()
    track = cfg.mnf.enabled and "events" in cache["scan"]
    cur = logits[:, -1].argmax(-1)[:, None]
    pos = torch.full((), plen, dtype=torch.int64, device=dev)
    inputs, out, ev_steps, kept = [], [], [], []
    debug = torch.cuda.get_sync_debug_mode() \
        if dev.type == "cuda" and mesh is None else None
    t0 = time.perf_counter()
    try:
        if debug is not None:
            torch.cuda.set_sync_debug_mode("error")
        for i in range(gen):
            tok = cur if teacher is None else teacher[:, i:i + 1]
            inputs.append(tok)
            logits, cache = srv.fn(params, cache, dict(tokens=tok), pos)
            # the graph advanced its own position; the eager step did not
            pos = srv.fn.position if graph else pos + 1
            cur = logits[:, -1].argmax(-1)[:, None]
            out.append(cur)
            if keep_logits:
                kept.append(logits[:, -1].clone())
            if track:
                ev_steps.append(whole(cache["scan"]["events"]).clone())
    finally:
        if debug is not None:
            torch.cuda.set_sync_debug_mode(debug)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    launches = None
    if graph:
        launches = {}
        for g in captured:
            for w, n in g.launches.items():
                launches[w] = launches.get(w, 0) + n * g.replays
    return dict(tokens=torch.cat(out, 1), inputs=torch.cat(inputs, 1),
                events=torch.stack(ev_steps) if track else None,
                logits=torch.stack(kept) if keep_logits else None,
                prefill_logits=prefill_logits, cache=cache,
                prefill_s=t_prefill, decode_s=t_decode,
                capture_s=sum(g.warmup_s + g.capture_s for g in captured),
                launches=launches, engine=srv.engine)


def lm_stats(cfg, run: dict, batch: int, prompt_len: int, gen: int,
             device: torch.device) -> dict:
    """The JAX driver's stats dict from a :func:`run_lm` result."""
    stats = dict(
        arch=cfg.name, batch=batch, prompt_len=prompt_len, generated=gen,
        prefill_s=round(run["prefill_s"], 3),
        capture_s=round(run["capture_s"], 3),
        decode_tok_per_s=round(gen * batch / run["decode_s"], 1),
        mnf=cfg.mnf.enabled, engine=dataclasses.asdict(run["engine"]),
        device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu"),
        sample_tokens=[int(t) for t in run["tokens"][0][:8]])
    if run["events"] is not None:
        evm = run["events"].cpu()                   # (gen, L) counts
        per_tok = evm.sum(dim=1)
        stats["events_per_token"] = round(float(per_tok.mean()), 2)
        stats["events_per_token_min"] = round(float(per_tok.min()), 2)
        stats["events_per_token_max"] = round(float(per_tok.max()), 2)
        stats["events_per_layer"] = [round(float(x), 2)
                                     for x in evm.mean(dim=0)]
    return stats


def serve_lm(args) -> dict:
    dev = default_device() if args.device is None \
        else torch.device(args.device)
    cfg = lm_config(args.arch, reduced=args.reduced, mnf=args.mnf,
                    threshold=args.mnf_threshold)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32
    params = tfm.init_compute_params(args.seed, cfg, dev)
    prompts = make_prompts(cfg, args.batch, args.prompt_len, args.seed, dev)
    inputs = make_lm_inputs(cfg, args.batch, args.seed, dev)
    mesh = _world_mesh(lambda world, d: checked_mesh(
        (world, 1), ("data", "model"), device_type=d.type), dev)
    with torch.inference_mode():
        run = run_lm(params, cfg, prompts, args.gen, mesh=mesh, **inputs)
    return lm_stats(cfg, run, args.batch, args.prompt_len, args.gen, dev)


def _cnn_spec(name: str, size: int):
    from repro_torch.models.cnn import (ALEXNET, ALEXNET_DS, MINI, VGG16,
                                        VGG16_DS)
    return {"alexnet": ALEXNET, "vgg16": VGG16, "alexnet_ds": ALEXNET_DS,
            "vgg16_ds": VGG16_DS, "mini": MINI}[name].scaled(size)


def _mlp_spec(name: str):
    from repro_torch.models.mlp import LENET_300_100, MLP_MINI
    return {"lenet": LENET_300_100, "mini": MLP_MINI}[name]


def _init_params(spec, seed: int, device, weight_sparsity: float) -> list:
    from repro_torch.models import cnn, mlp
    gen = torch.Generator(device=device).manual_seed(seed)
    init = mlp.init_mlp_params if isinstance(spec, mlp.MLPSpec) \
        else cnn.init_cnn_params
    return init(spec, gen, weight_sparsity=weight_sparsity)


def make_requests(spec, n: int, seed: int) -> torch.Tensor:
    """``n`` relu(normal) requests on the host, made from ``seed``: images
    (n, H, W, C) for a CNN, vectors (n, in_features) for an MLP."""
    from repro_torch.models.mlp import MLPSpec
    shape = (spec.in_features,) if isinstance(spec, MLPSpec) else \
        (spec.input_size, spec.input_size, spec.in_ch)
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n,) + shape, generator=gen).clamp_(min=0.0)


def _fail(failures: list) -> None:
    if failures:
        print("serve smoke FAILED:\n  " + "\n  ".join(failures),
              file=sys.stderr)
        raise SystemExit(1)


def serve_cnn(args) -> dict:
    """Continuously batched CNN/MLP serving through the bucketed replica.
    ``--mlp`` serves an FC network through the same tier — flat request
    vectors; every boundary is FC→FC, so its report must state zero
    densify points (DESIGN.md §12).  Fails (exit 1) on a steady-state
    capture, a fallback_decode at an eligible boundary, or MLP densify
    points; prints the stats JSON line either way."""
    from repro_torch import engine, serving
    from repro_torch.costmodel import crossover as xover

    dev = default_device() if args.device is None \
        else torch.device(args.device)
    spec = _mlp_spec(args.mlp) if args.mlp \
        else _cnn_spec(args.cnn, args.cnn_size)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    table = None
    if args.route == "adaptive":
        # installed explicitly: the engine never reads a file on its own
        table = xover.load_crossover_table(args.bench)
    ecfg = engine.EngineConfig(threshold=args.mnf_threshold,
                               route=args.route,
                               occupancy_hint=args.occupancy_hint)
    prev = xover.set_active_table(table) if table is not None else None
    try:
        params = _init_params(spec, args.seed, dev, args.weight_sparsity)
        eng = serving.ServeEngine(
            spec, params,
            serving.ServeEngineConfig(buckets=buckets, mnf=not args.dense),
            engine_cfg=ecfg, device=dev,
            mesh=_world_mesh(lambda world, d: make_serve_mesh(
                device_type=d.type), dev))

        # made ahead of the loop: requests/s measures the pipeline, not
        # the host's random number generator
        images = make_requests(spec, args.rate * args.ticks, args.seed)
        warm = eng.recompiles
        with torch.inference_mode():
            serve_arrivals(eng, images, [args.rate] * args.ticks)
        stats = eng.stats()
        report = eng.boundary_report()
    finally:
        if table is not None:
            xover.set_active_table(prev)

    failures = []
    if eng.recompiles != warm:
        failures.append(f"steady-state recompiles: {eng.recompiles - warm} "
                        f"captures after the warm-up (the count must stay "
                        f"flat)")
    if not args.dense and report["fallback_decodes"]:
        failures.append(f"eligible boundary reported fallback_decode: "
                        f"{report}")
    if args.mlp and eng.plans[buckets[0]].boundaries.get("densify", 0):
        failures.append(f"MLP replica reports densify points: "
                        f"{eng.plans[buckets[0]].boundaries}")
    out = dict(
        net=spec.name,
        input_size=spec.in_features if args.mlp else spec.input_size,
        buckets=list(buckets), mnf=not args.dense,
        engine=dataclasses.asdict(eng.engine_cfg), boundaries=report,
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"), **stats)
    if table is not None:
        out["crossover_table"] = dict(path=args.bench, device=table.device,
                                      entries=table.entries,
                                      curves=len(table))
    print(json.dumps(out), flush=True)
    _fail(failures)
    return out


def serve_arrivals(eng, requests, arrivals, on_tick=None) -> None:
    """Submit ``requests`` in order, ``arrivals[i]`` of them before tick
    i, and run each tick; ``on_tick(n, done)``, when given, sees each
    tick's arrivals and completions."""
    it = iter(requests)
    for n in arrivals:
        for _ in range(n):
            eng.submit(next(it))
        done = eng.run_tick()
        if on_tick is not None:
            on_tick(n, done)


def serve_smoke(args) -> None:
    """The serving tier's gate: the mini CNN (MINI@8) and MLP (MLP_MINI)
    through buckets (1, 2, 4), exit 1 on any broken invariant — served
    count and FIFO order, no steady-state capture, no fallback_decode,
    padded-bucket logits bitwise the unpadded forward at n = 1, 3, 9, a
    second (re-captured) replica reporting identical routes, an MLP
    replica with no densify or re-tile point."""
    from repro_torch import serving
    from repro_torch.models import cnn, mlp

    dev = default_device() if args.device is None \
        else torch.device(args.device)
    buckets = (1, 2, 4)
    cfg = serving.ServeEngineConfig(buckets=buckets)
    spec = _cnn_spec("mini", 8)
    params = _init_params(spec, 0, dev, 0.5)
    failures = []
    with torch.inference_mode():
        eng = serving.ServeEngine(spec, params, cfg, device=dev)
        warm = eng.recompiles
        images = make_requests(spec, 9, 0)
        # buckets 1, 4, (idle), 4 + 1
        serve_arrivals(eng, images, (1, 3, 0, 5))
        if len(eng.completed) != 9:
            failures.append(f"served {len(eng.completed)}/9 requests")
        rids = [r.rid for r in eng.completed]
        if rids != sorted(rids):
            failures.append("completion order is not FIFO")
        if eng.recompiles != warm:
            failures.append(f"{eng.recompiles - warm} steady-state "
                            f"captures (the count must stay flat after the "
                            f"warm-up)")
        report = eng.boundary_report()
        if report["fallback_decodes"]:
            failures.append(f"eligible boundary reported fallback_decode: "
                            f"{report}")
        # real rows of every padded bucket == the unpadded forward
        for n in (1, 3, 9):
            ref = cnn.make_cnn_pipeline(spec, batch=n, device=dev)(
                eng.params, images[:n].to(dev)).cpu()
            got = torch.stack([r.result for r in eng.completed[:n]])
            if not torch.equal(ref, got):
                failures.append(f"padded-bucket logits not bitwise the "
                                f"unpadded forward at n={n}")
        # a second replica re-captures every bucket; its routes are static
        # per shape, so they must be the first one's
        eng2 = serving.ServeEngine(spec, params, cfg, device=dev)
        if eng2.recompiles != len(buckets):
            failures.append(f"second replica captured {eng2.recompiles} "
                            f"buckets, not {len(buckets)}")
        report2 = eng2.boundary_report()
        if report2["routes"] != report["routes"]:
            failures.append(f"second replica reports other routes: "
                            f"{report2['routes']} != {report['routes']}")
        del eng2

        # the FC family through the same tier: every boundary FC→FC
        mspec = _mlp_spec("mini")
        meng = serving.ServeEngine(mspec, _init_params(mspec, 0, dev, 0.5),
                                   cfg, device=dev)
        mwarm = meng.recompiles
        vecs = make_requests(mspec, 7, 1)
        serve_arrivals(meng, vecs, (1, 2, 4))
        mreport = meng.boundary_report()
        if len(meng.completed) != 7:
            failures.append(f"MLP tier served {len(meng.completed)}/7 "
                            f"requests")
        if meng.recompiles != mwarm:
            failures.append(f"MLP tier: {meng.recompiles - mwarm} "
                            f"steady-state captures")
        if mreport["fallback_decodes"]:
            failures.append(f"MLP tier: eligible FC boundary reported "
                            f"fallback_decode: {mreport}")
        if mreport["boundaries"].get("densify", 0) or \
                mreport["boundaries"].get("retile", 0):
            failures.append(f"MLP tier: FC→FC chain reports densify/retile "
                            f"points: {mreport['boundaries']}")
        mref = mlp.make_mlp_pipeline(mspec, batch=7, device=dev)(
            meng.params, vecs.to(dev)).cpu()
        if not torch.equal(mref, torch.stack([r.result
                                              for r in meng.completed])):
            failures.append("MLP tier: padded-bucket logits not bitwise the "
                            "unpadded forward")
    print(json.dumps(dict(smoke="serve", boundaries=report,
                          mlp_boundaries=mreport, **eng.stats())),
          flush=True)
    _fail(failures)
    print("serve smoke OK: no steady-state captures, no fallback_decode, "
          "padding bitwise-exact, re-captured routes identical, MLP tier "
          "densify-free", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="rwkv6-7b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mnf", action="store_true",
                    help="enable the MNF fire phase (fire-gated decode)")
    ap.add_argument("--mnf-threshold", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--cnn", choices=("alexnet", "vgg16", "alexnet_ds",
                                      "vgg16_ds", "mini"),
                    help="serve a CNN through the bucketed serving replica "
                         "instead of an LM (the _ds variants downsample "
                         "with stride-2 convs)")
    ap.add_argument("--cnn-size", type=int, default=64,
                    help="CNN input resolution (224 = paper scale)")
    ap.add_argument("--mlp", choices=("lenet", "mini"),
                    help="serve an FC network (lenet = LeNet-300-100) "
                         "through the same bucketed replica: flat request "
                         "vectors, zero densify points (DESIGN.md §12)")
    ap.add_argument("--buckets", default="1,8,32,128",
                    help="CNN mode: captured batch bucket sizes, ascending")
    ap.add_argument("--rate", type=int, default=8,
                    help="CNN mode: synthetic request arrivals per tick")
    ap.add_argument("--ticks", type=int, default=8,
                    help="CNN mode: serving ticks to run")
    ap.add_argument("--smoke", action="store_true",
                    help="the serving tier's gate: mini nets through "
                         "buckets (1, 2, 4); exit 1 on a steady-state "
                         "capture, fallback_decode or padding drift")
    ap.add_argument("--dense", action="store_true",
                    help="CNN mode: serve the dense oracle path instead of "
                         "MNF events (the default)")
    ap.add_argument("--weight-sparsity", type=float, default=0.5,
                    help="CNN mode: unstructured weight pruning density")
    ap.add_argument("--route", default="auto",
                    choices=("auto", "adaptive", "dense", "event", "strip",
                             "pixel", "window"),
                    help="CNN mode: per-boundary routing policy: auto "
                         "(geometry, event-first), adaptive (the cost "
                         "model's or the crossover table's argmin at "
                         "--occupancy-hint) or a forced route (DESIGN.md "
                         "§11)")
    ap.add_argument("--occupancy-hint", type=float, default=None,
                    help="CNN mode: static occupancy the adaptive router "
                         "decides at (default 1.0), recorded with each "
                         "routing decision")
    ap.add_argument("--bench", default="BENCH_engine.json",
                    help="CNN mode: benchmark file whose crossover entries "
                         "make the adaptive routing table")
    args = ap.parse_args(argv)

    if args.smoke:
        serve_smoke(args)
        return
    if args.cnn and args.mlp:
        ap.error("--cnn and --mlp are mutually exclusive")
    if args.cnn or args.mlp:
        if args.dense and (args.mnf or args.mnf_threshold != 0.0):
            ap.error("--dense conflicts with --mnf/--mnf-threshold (CNN/MLP "
                     "mode serves MNF by default)")
        serve_cnn(args)
        return
    cfg = lm_config(args.arch, reduced=args.reduced)
    if args.prompt_len < cfg.vision_tokens:
        ap.error(f"--arch {args.arch}: --prompt-len {args.prompt_len} is "
                 f"shorter than the {cfg.vision_tokens} vision tokens that "
                 f"fill the prompt's leading positions")
    print(json.dumps(serve_lm(args)), flush=True)


if __name__ == "__main__":
    main()
