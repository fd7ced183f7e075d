"""Event-native MLP workloads — the paper's FC/MNIST-class networks, port
of ``repro.models.mlp``.

The FC twin of ``models/cnn.py``, on the same engine seams (DESIGN.md §12):

  * dense (``mnf=False``) — the engine's dense backend + ReLU, the oracle;
  * mnf — event-resident: ``engine.fire`` emits an ``EventStream`` after
    every hidden layer and the next ``engine.linear`` consumes it directly.
    Every boundary is FC→FC, already in the flattened view, so the chained
    forward has zero densify points by construction.  With int8 event
    values every boundary requantizes; the round-trip twin is then the
    fake-quant forward, and the chain matches it bitwise.

The forward runs on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import engine
from repro_torch.core.fire import FireConfig, fire
from repro_torch.device import default_device
from repro_torch.models.cnn import (FCSpec, Pipeline, _read_stats,
                                    fc_in_events)

__all__ = ["MLPSpec", "LENET_300_100", "MLP_MINI", "init_mlp_params",
           "make_mlp_forward", "make_mlp_pipeline", "mlp_boundary_summary",
           "mlp_forward", "mlp_layer_dense_macs", "run_mlp_with_stats"]


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    """``in_features -> widths[0] -> ... -> widths[-1]`` with a fire
    (ReLU-family) boundary between layers and raw logits out of the last;
    ``widths[-1]`` is the class count."""

    name: str
    in_features: int
    widths: tuple

    @property
    def num_classes(self) -> int:
        return self.widths[-1]

    @property
    def layers(self) -> tuple:
        """FCSpec view of the stack — the CNN models' layer vocabulary."""
        return tuple(FCSpec(w) for w in self.widths)

    def feature_sizes(self) -> tuple:
        """Input width entering each layer."""
        return (self.in_features,) + self.widths[:-1]


#: The paper's MNIST-class workload: LeNet-300-100 (784 -> 300 -> 100 -> 10).
LENET_300_100 = MLPSpec("lenet_300_100", 784, (300, 100, 10))

#: Seconds-scale MLP with both FC→FC chain boundaries.
MLP_MINI = MLPSpec("mlp_mini", 64, (32, 16, 10))


def init_mlp_params(spec: MLPSpec, generator: torch.Generator, *,
                    weight_sparsity: float = 0.0) -> list:
    """He-initialized (K, N) weights drawn from ``generator`` on its
    device; optional unstructured pruning."""
    dev = generator.device
    params = []
    for fan_in, out in zip(spec.feature_sizes(), spec.widths):
        wgt = torch.randn((fan_in, out), generator=generator, device=dev) \
            * (2.0 / fan_in) ** 0.5
        if weight_sparsity > 0.0:
            keep = torch.rand((fan_in, out), generator=generator, device=dev)
            wgt = torch.where(keep >= weight_sparsity, wgt, 0.0)
        params.append(wgt)
    return params


def mlp_layer_dense_macs(spec: MLPSpec) -> list:
    """Per-layer dense MAC counts (what a dense accelerator does)."""
    return [fan_in * out
            for fan_in, out in zip(spec.feature_sizes(), spec.widths)]


def _mlp_cfg(base: engine.EngineConfig | None, *, mnf: bool,
             fire_cfg: FireConfig) -> engine.EngineConfig:
    cfg = base or engine.EngineConfig()
    if not mnf:
        cfg = cfg.replace(backend="dense")
    return cfg.replace(threshold=fire_cfg.threshold,
                       magnitude=fire_cfg.magnitude,
                       int8_events=cfg.int8_events
                       or fire_cfg.quantize_to_int8)


def mlp_boundary_summary(spec: MLPSpec, *, batch: int = 1,
                         fire_cfg: FireConfig = FireConfig(),
                         engine_cfg: engine.EngineConfig | None = None,
                         device=None) -> dict:
    """Static per-boundary accounting of the chained MLP, in the schema of
    ``models.cnn.chain_boundary_summary``: every boundary past the input is
    FC→FC, so ``densify`` and ``retile`` are structurally 0, and ``routes``
    lists the ``engine.route_linear`` decision of each stream-consuming
    boundary."""
    cfg = _mlp_cfg(engine_cfg, mnf=True, fire_cfg=fire_cfg)
    out = dict(conv=0, fc=len(spec.widths), pool=0, pool_events=0,
               densify=0, input_encode=0, retile=0, routes=[])
    for fan_in, width in list(zip(spec.feature_sizes(), spec.widths))[1:]:
        dec = engine.route_linear(batch, fan_in, width, cfg, device=device)
        out["routes"].append(dict(
            op="linear", route=dec.route, occupancy=dec.occupancy,
            est_event_cost=dec.est_event_cost,
            est_dense_cost=dec.est_dense_cost, source=dec.source,
            shape_class=engine.linear_shape_class(batch, fan_in, width)))
    return out


def _forward(params, x, spec: MLPSpec, *, fire_cfg: FireConfig,
             cfg: engine.EngineConfig, chain: bool,
             stats: list | None = None):
    """The one forward body.  ``chain=True`` threads one EventStream through
    fire→linear→fire→…; the head passes the dense input straight into
    ``engine.linear``, whose event backends encode it at threshold 0 — the
    encode the twin's first layer runs, so both multiply the same tiles.
    ``chain=False`` is the per-layer round-trip twin.  ``stats`` (a list
    to append to) asks for each layer's ``in_events`` and ``event_macs``
    as device tensors; with None the forward runs nothing for it."""
    fcfg = cfg.replace(threshold=0.0)
    layers = spec.layers
    for i, (layer, wgt) in enumerate(zip(layers, params)):
        if stats is not None:
            in_ev = fc_in_events(x, fire_cfg.threshold)
            stats.append(dict(event_macs=in_ev * layer.out,  # Algorithm 2
                              in_events=in_ev))
        acc = engine.linear(x, wgt, cfg=fcfg)
        if i == len(layers) - 1:
            x = acc
        elif chain:
            x = engine.fire(acc, cfg, keep_dense=False)
        else:
            x = fire(acc, fire_cfg)
    return x


def make_mlp_forward(spec: MLPSpec, *, mnf: bool = True,
                     fire_cfg: FireConfig = FireConfig(),
                     engine_cfg: engine.EngineConfig | None = None,
                     chain: bool | None = None):
    """The whole-network closure ``fwd(params, x) -> logits`` on tensors
    already on their device."""
    cfg = _mlp_cfg(engine_cfg, mnf=mnf, fire_cfg=fire_cfg)
    chain = mnf if chain is None else chain and mnf

    def fwd(params, x):
        return _forward(params, x, spec, fire_cfg=fire_cfg, cfg=cfg,
                        chain=chain)

    return fwd


def make_mlp_pipeline(spec: MLPSpec, *, batch: int, mnf: bool = True,
                      fire_cfg: FireConfig = FireConfig(),
                      engine_cfg: engine.EngineConfig | None = None,
                      chain: bool | None = None, device=None) -> Pipeline:
    """One compiled forward per (network, batch, event type):
    ``fn(params, x) -> logits`` for x (batch, in_features), a CUDA graph of
    :func:`make_mlp_forward` on the card (``models.cnn.Pipeline``: bound
    to the parameter tensors of its first call, logits rewritten by the
    next call).  Runs on the card (``default_device()``) unless ``device``
    says otherwise."""
    dev = default_device() if device is None else torch.device(device)
    fwd = make_mlp_forward(spec, mnf=mnf, fire_cfg=fire_cfg,
                           engine_cfg=engine_cfg, chain=chain)
    return Pipeline(fwd, (batch, spec.in_features), dev)


def mlp_forward(params, x, spec: MLPSpec, *, mnf: bool = True,
                fire_cfg: FireConfig = FireConfig(),
                engine_cfg: engine.EngineConfig | None = None,
                chain: bool | None = None, device=None) -> torch.Tensor:
    """x (B, in_features) -> logits (B, classes).  ``mnf=False`` is the
    dense oracle; ``chain=False`` the per-layer round-trip twin.  Runs on
    the card (``default_device()``) unless ``device`` says otherwise;
    inputs and params move there."""
    dev = default_device() if device is None else torch.device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    params = [p.to(dev) for p in params]
    fwd = make_mlp_forward(spec, mnf=mnf, fire_cfg=fire_cfg,
                           engine_cfg=engine_cfg, chain=chain)
    return fwd(params, x)


def run_mlp_with_stats(params, x, spec: MLPSpec,
                       fire_cfg: FireConfig = FireConfig(),
                       engine_cfg: engine.EngineConfig | None = None, *,
                       device=None):
    """The chained MNF forward plus per-layer event accounting: (logits,
    stats list), each layer's ``dense_macs`` (static), ``event_macs``
    (Algorithm 2: in_events × out) and ``in_events``; one eager forward,
    its counts read from the device in one copy.  Runs on the card unless
    ``device`` says otherwise."""
    dev = default_device() if device is None else torch.device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    params = [p.to(dev) for p in params]
    cfg = _mlp_cfg(engine_cfg, mnf=True, fire_cfg=fire_cfg)
    traced: list = []
    logits = _forward(params, x, spec, fire_cfg=fire_cfg, cfg=cfg,
                      chain=True, stats=traced)
    static = [dict(kind="fc", dense_macs=float(x.shape[0] * macs))
              for macs in mlp_layer_dense_macs(spec)]
    return logits, _read_stats(static, traced)
