"""End-to-end driver of the port (the paper's kind: INFERENCE): event-driven
CNN serving, priced in the paper's units — the twin of
``examples/serve_cnn_events.py`` on ``repro_torch``.

Serves image requests through the serving tier (``repro_torch.serving``,
DESIGN.md §10): a FIFO queue continuously batched into padded buckets, one
CUDA graph per bucket on the card.  Every completed request is checked
against the dense oracle (``make_cnn_pipeline(mnf=False)``, within 5e-3),
one frame's per-layer event counts (``run_with_stats``) feed the cost
model, and the paper's accelerator is priced on them (``table4_row``,
``network_cycles``): frames/s, mW and frames/J of the paper's 200 MHz
ASIC (Table 3), model numbers and not times on the card.  Requests are
``data.cnn_batch`` frames (step i for request i, seed 0), the weights He
from a seeded generator with unstructured pruning::

    PYTHONPATH=src python examples/torch_serve_cnn_events.py
    PYTHONPATH=src python examples/torch_serve_cnn_events.py --device cpu

The JAX driver's ``--cache-dir`` has no counterpart: a CUDA graph cannot be
written to disk (``repro_torch.serving``).  ``serve_cnn_events`` is the
body, callable with other weights, arrivals or an engine config.
"""
import argparse
import time

import torch

from repro_torch.costmodel import network_cycles, table4_row
from repro_torch.data import cnn_batch
from repro_torch.device import default_device
from repro_torch.engine import EngineConfig
from repro_torch.models.cnn import (ALEXNET, VGG16, init_cnn_params,
                                    make_cnn_pipeline, run_with_stats)
from repro_torch.serving import ServeEngine, ServeEngineConfig

__all__ = ["main", "serve_cnn_events"]


def serve_cnn_events(net: str = "alexnet", size: int = 64, *,
                     rate: int = 4, ticks: int = 4,
                     buckets: tuple = (1, 4, 8),
                     weight_sparsity: float = 0.5,
                     act_sparsity: float = 0.6, device=None,
                     params: list | None = None, arrivals=None,
                     engine_cfg: EngineConfig | None = None) -> dict:
    """Serve ``arrivals`` (default ``rate`` a tick for ``ticks`` ticks)
    frames of ``net`` at ``size`` through buckets ``buckets`` on
    ``device`` (the card unless the caller asks), check every served row
    against the dense oracle (atol and rtol 5e-3) and price the first
    frame's measured events.  ``params`` defaults to
    ``init_cnn_params`` from seed 0 at ``weight_sparsity``.  Returns
    ``stats`` (``ServeEngine.stats``), ``layer_stats`` (the first frame's
    ``run_with_stats``), ``row`` (``table4_row``), ``cycles`` (MNF's
    ``network_cycles``), the ``engine`` (its graphs live while it does),
    ``params``, ``frames`` (host), ``oracle`` (the dense logits, host),
    ``logits`` (the first frame's from ``run_with_stats``, host) and
    ``warm_s``."""
    dev = default_device() if device is None else torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    spec = (ALEXNET if net == "alexnet" else VGG16).scaled(size)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_cnn_params(spec, gen, weight_sparsity=weight_sparsity)
    arrivals = list(arrivals) if arrivals is not None else [rate] * ticks

    t0 = time.perf_counter()
    eng = ServeEngine(spec, params, ServeEngineConfig(buckets=buckets),
                      engine_cfg=engine_cfg, device=dev)
    warm_s = time.perf_counter() - t0
    print(f"replica warmed in {warm_s:.1f}s (buckets {list(buckets)}, "
          f"warm-up and capture {eng.warmup_s})", flush=True)

    # synthetic traffic, made ahead of the serving loop; the dense oracle
    # (one pipeline over all frames) checks every request
    n_requests = sum(arrivals)
    frames = torch.cat([
        cnn_batch(1, size, spec.in_ch, i, activation_sparsity=act_sparsity,
                  device="cpu")
        for i in range(n_requests)])
    with torch.inference_mode():
        it = iter(frames)
        for n in arrivals:
            for _ in range(n):
                eng.submit(next(it))
            eng.run_tick()
        stats = eng.stats()
        assert len(eng.completed) == n_requests, "queue did not drain"

        ref_fn = make_cnn_pipeline(spec, batch=n_requests, mnf=False,
                                   device=dev)
        ref = ref_fn(eng.params, frames.to(dev)).cpu()
        del ref_fn
        for i, req in enumerate(eng.completed):
            assert torch.allclose(req.result, ref[req.rid], atol=5e-3,
                                  rtol=5e-3), \
                f"request {req.rid} diverged from the dense oracle"
            if i < arrivals[0]:
                print(f"req {req.rid}: bucket {req.bucket} "
                      f"latency {req.latency_s * 1e3:.1f}ms "
                      f"pred={int(torch.argmax(req.result))}")

        # price one frame's measured event stream on the paper's ASIC
        logits, layer_stats = run_with_stats(eng.params, frames[:1], spec,
                                             device=dev)
    w_density = 1 - weight_sparsity
    row = table4_row(layer_stats, w_density=w_density)
    cyc = network_cycles(layer_stats, "mnf", d_w=w_density)
    dense_macs = sum(s["dense_macs"] for s in layer_stats)
    event_macs = sum(s["event_macs"] for s in layer_stats)
    print(f"\nserved {stats['requests']} frames at "
          f"{stats['requests_s']:.1f} req/s "
          f"(p50 {stats['p50_ms']:.1f}ms, p99 {stats['p99_ms']:.1f}ms, "
          f"{stats['recompiles']} captures, all at warmup)")
    print(f"event/dense MAC ratio: {event_macs / dense_macs:.3f}")
    print(f"modeled on MNF ASIC (Table 3 hw): {row['frames_s']:.1f} "
          f"frames/s, {row['power_mw']:.1f} mW, {row['frames_j']:.1f} "
          f"frames/J ({cyc:,.0f} cycles/frame)", flush=True)
    return dict(stats=stats, layer_stats=layer_stats, row=row, cycles=cyc,
                engine=eng, params=params, frames=frames, oracle=ref,
                logits=logits.cpu(), warm_s=warm_s)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--net", choices=("alexnet", "vgg16"), default="alexnet")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--rate", type=int, default=4,
                    help="request arrivals per serving tick")
    ap.add_argument("--ticks", type=int, default=4)
    ap.add_argument("--buckets", default="1,4,8",
                    help="captured batch bucket sizes, ascending")
    ap.add_argument("--weight-sparsity", type=float, default=0.5)
    ap.add_argument("--act-sparsity", type=float, default=0.6)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)
    return serve_cnn_events(
        args.net, args.size, rate=args.rate, ticks=args.ticks,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        weight_sparsity=args.weight_sparsity,
        act_sparsity=args.act_sparsity, device=args.device)


if __name__ == "__main__":
    main()
