"""LM serving driver: prefill, then the greedy decode loop — port of the LM
mode of ``repro.launch.serve`` on one device, no mesh::

    python -m repro_torch.launch.serve --arch rwkv6-7b --mnf
    python -m repro_torch.launch.serve --arch hymba-1.5b --mnf
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --reduced --device cpu --mnf

Weights are random from ``--seed`` (f32, as the config's param dtype; the
leaves a block casts are cast once to the compute dtype), prompts are
random tokens from the same seed.  With MNF on (``--mnf`` or a non-zero
``--mnf-threshold``; RWKV6-7B and Hymba-1.5B have it on by default) every
decode step runs the fire-gated state update (B7 for RWKV6, B8 for
Hymba's Mamba heads, on the card) and reports its fired events; Hymba's
prefill runs its selective scan through B10 on the card either way.
On the card the prefill and the decode step run as CUDA graphs
(``launch.steps``), captured before the timed runs.  Prints one stats
JSON line: ``prefill_s`` and ``decode_tok_per_s`` (warm replays),
``capture_s``, ``events_per_token`` with its min and max,
``events_per_layer``.

The prompt is ``--prompt-len`` tokens.  (The JAX driver prefills
``prompt-len + gen`` tokens under the same flag; ROADMAP.md queue C.)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import default_device
from repro_torch.launch import steps
from repro_torch.models import transformer as tfm

__all__ = ["lm_config", "main", "make_prompts", "run_lm", "serve_lm"]


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


def run_lm(params, cfg, prompts: torch.Tensor, gen: int, *,
           teacher: torch.Tensor | None = None, keep_logits: bool = False,
           graph: bool = True) -> dict:
    """Prefill ``prompts`` (B, P), then ``gen`` greedy decode steps.

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
    """
    bsz, plen = prompts.shape
    dev = prompts.device
    max_len = plen + gen
    graph = graph and dev.type == "cuda"
    pool = torch.cuda.graph_pool_handle() if graph else None
    pre = steps.make_prefill_step(cfg, ShapeConfig("pf", max_len, bsz,
                                                   "prefill"),
                                  graph=graph, pool=pool)
    srv = steps.make_serve_step(cfg, ShapeConfig("serve", max_len, bsz,
                                                 "decode"),
                                graph=graph, pool=pool)
    captured = [pre.fn.capture(params, prompts),
                srv.fn.capture(params, dev)] if graph else []
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = pre.fn(params, dict(tokens=prompts))
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits.clone()
    track = cfg.mnf.enabled and "events" in cache["scan"]
    cur = logits[:, -1].argmax(-1)[:, None]
    pos = torch.full((), plen, dtype=torch.int64, device=dev)
    inputs, out, ev_steps, kept = [], [], [], []
    debug = torch.cuda.get_sync_debug_mode() if dev.type == "cuda" else None
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
                ev_steps.append(cache["scan"]["events"].clone())
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
                capture_s=sum(g.capture_s for g in captured),
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
    params = tfm.compute_params(tfm.init_params(args.seed, cfg, dev), cfg)
    prompts = make_prompts(cfg, args.batch, args.prompt_len, args.seed, dev)
    with torch.inference_mode():
        run = run_lm(params, cfg, prompts, args.gen)
    return lm_stats(cfg, run, args.batch, args.prompt_len, args.gen, dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="rwkv6-7b",
                    choices=("rwkv6-7b", "hymba-1.5b"))
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
    args = ap.parse_args(argv)
    print(json.dumps(serve_lm(args)), flush=True)


if __name__ == "__main__":
    main()
