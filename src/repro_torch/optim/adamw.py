"""AdamW with decoupled weight decay and global-norm clipping — port of
``repro.optim.adamw``.

Params, gradients and moments are nested dicts of tensors (the models'
param trees); the optimizer state mirrors the param tree leaf for leaf.
Every function but :func:`adamw_update_` is functional, as in the JAX
package: the update returns new trees and leaves its inputs as they are.
The update clips first, takes the bias-corrected moments, adds the
decoupled weight decay, and computes the new param in f32 before casting
it back to the param's dtype.  :func:`adamw_update_` does the same
arithmetic in the same order, writing each leaf's new param and moments
into the given tensors (the counterpart of the JAX step's donated
buffers: what a CUDA graph of the train step updates in place).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models.param_utils import tree_leaves, tree_map

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "adamw_update_", "clip_by_global_norm", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                  # used when schedule is None
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: Callable[[torch.Tensor], torch.Tensor] | None = None


class OptState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor               # 0-d int32, the steps taken


def adamw_init(params) -> OptState:
    """Zero f32 moments beside each param, and a step count of 0 on the
    params' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    count=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-d)."""
    sq = [torch.sum(torch.square(t.float())) for t in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(f32 grads scaled to a global norm of at most ``max_norm``, the
    global norm before the scaling)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


def _step_terms(count: torch.Tensor, cfg: AdamWConfig):
    """(lr, 1 - b1^count, 1 - b2^count) at the new ``count``; lr a Python
    float when ``cfg.schedule`` is None."""
    lr = cfg.schedule(count) if cfg.schedule is not None else cfg.lr
    cf = count.float()
    return lr, 1.0 - torch.pow(cfg.b1, cf), 1.0 - torch.pow(cfg.b2, cf)


def _leaf_update(g, m, v, p, cfg: AdamWConfig, lr, b1c, b2c):
    """One leaf's (new param in its dtype, new m, new v); ``g`` clipped."""
    g = g.float()
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
    step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    step = step + cfg.weight_decay * p.float()
    return (p.float() - lr * step).to(p.dtype), m, v


def adamw_update(grads, state: OptState, params, cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics): ``grad_norm`` (before
    clipping) and ``lr``, 0-d f32 tensors."""
    grads, gn = clip_by_global_norm(grads, cfg.grad_clip)
    count = state.count + 1
    lr, b1c, b2c = _step_terms(count, cfg)
    new = tree_map(lambda g, m, v, p: _leaf_update(g, m, v, p, cfg, lr, b1c,
                                                   b2c),
                   grads, state.mu, state.nu, params)
    pick = lambda i: tree_map(lambda t: t[i], new)  # noqa: E731
    metrics = dict(grad_norm=gn, lr=torch.as_tensor(
        lr, dtype=torch.float32, device=gn.device))
    return pick(0), OptState(pick(1), pick(2), count), metrics


def adamw_update_(grads, state: OptState, params, cfg: AdamWConfig) -> dict:
    """:func:`adamw_update` in place: ``params``, ``state.mu``,
    ``state.nu`` and ``state.count`` are overwritten with the values
    :func:`adamw_update` returns, bitwise.  The global norm is taken over
    every gradient first; then leaf by leaf the gradient is clipped and
    the leaf's new param and moments computed and copied in before the
    next leaf, so no second copy of the state is ever held.  Returns the
    metrics, 0-d f32 tensors on the device; a Python ``cfg.lr`` enters
    the metrics by a fill on the device, with no copy from the host."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, cfg.grad_clip)
    state.count.add_(1)
    lr, b1c, b2c = _step_terms(state.count, cfg)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(params)):
        new_p, new_m, new_v = _leaf_update(g.float() * scale, m, v, p, cfg,
                                           lr, b1c, b2c)
        p.copy_(new_p)
        m.copy_(new_m)
        v.copy_(new_v)
    if not isinstance(lr, torch.Tensor):
        lr = torch.full((), lr, dtype=torch.float32, device=gn.device)
    return dict(grad_norm=gn, lr=lr)
