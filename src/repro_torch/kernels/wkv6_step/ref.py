"""Plain PyTorch version of the fire-gated WKV6 decode step (B7).

Port of ``repro.kernels.wkv6.step`` (``wkv6_step_ref``,
``drive_from_events``, ``wkv6_step_events_ref``).  Per flattened row
g = (batch, head)::

    o  = (sum_d r_d u_d k_d) v + r S       (bonus + state readout)
    S' = diag(w) S + k v^T                 (decay + rank-1 increment)

The increment is driven by the key vector alone, so the gated step takes
the fired key as events and runs the dense step's arithmetic on the drive
they carry (zeros where nothing fired).  The dense decode
(``models.ssm.wkv6_step``) calls :func:`wkv6_step_ref` too, so at
threshold 0 the gated step equals the dense one bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import events as ev

__all__ = ["drive_from_events", "wkv6_step_events_ref", "wkv6_step_ref"]


def wkv6_step_ref(r, k, v, w, u, s):
    """Dense single-token step, rows flattened.  r, k, v, w, u (G, D);
    s (G, D, D); all math f32.  Returns (o (G, D), s_new (G, D, D))."""
    r, k, v, w, u = (x.float() for x in (r, k, v, w, u))
    s = s.float()
    att = (r * u * k).sum(-1)                                 # (G,)
    o = att[:, None] * v + (r[:, :, None] * s).sum(1)
    s_new = w[..., None] * s + k[..., None] * v[:, None, :]
    return o, s_new


def drive_from_events(bev: ev.BlockEvents, *, blk_k: int, m: int,
                      k: int) -> torch.Tensor:
    """The fired (M, K) drive of blk_m == 1 events (zeros where nothing
    fired) — event consumption, the image of the kernel's row scatter."""
    g = bev.block_idx.shape[0]
    full = ev.decode_block_events(bev, blk_m=1, blk_k=blk_k, m=g,
                                  k=bev.num_k_blocks * blk_k)
    return full[:m, :k]


def wkv6_step_events_ref(bev: ev.BlockEvents, r, v, w, u, s, *,
                         blk_k: int):
    """The gated step on its events: the dense step on the event-carried
    key drive.  Same arguments as the kernel's wrapper."""
    k_used = drive_from_events(bev, blk_k=blk_k, m=r.shape[0], k=r.shape[1])
    return wkv6_step_ref(r, k_used, v, w, u, s)
