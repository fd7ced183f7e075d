"""Analytic per-layer stats for the paper's workloads at a density profile —
port of ``repro.costmodel.workloads``.

The schema of ``models.cnn.run_with_stats`` (dense_macs, event_macs,
in_events, in_elems, c_out, avg_touched, out_density), computed from the
layer shapes of the port's ``models.cnn`` specs times a per-layer
activation-density profile, so the full 224×224 VGG16/AlexNet accounting
runs instantly on the host.  ``run_with_stats`` on a real forward is the
measured counterpart; their shape-only fields agree exactly.
"""
from __future__ import annotations

from repro_torch.core.mnf_conv import conv_out_size
from repro_torch.models.cnn import (CNNSpec, ConvSpec, FCSpec, PoolSpec,
                                    _trace_shapes)

__all__ = ["analytic_network_stats"]


def analytic_network_stats(spec: CNNSpec, density_profile) -> list:
    """density_profile: per-compute-layer INPUT activation density."""
    shapes = _trace_shapes(spec)
    stats = []
    li = 0
    for i, layer in enumerate(spec.layers):
        h, w, c = shapes[i]
        if isinstance(layer, PoolSpec):
            continue
        d = density_profile[min(li, len(density_profile) - 1)]
        if isinstance(layer, ConvSpec):
            oy = conv_out_size(h, layer.k, layer.stride, layer.padding)
            ox = conv_out_size(w, layer.k, layer.stride, layer.padding)
            dense = oy * ox * layer.k ** 2 * c * layer.out_ch
            in_elems = h * w * c
            events = in_elems * d
            # interior pixels touch (k/s)² outputs, borders fewer: the exact
            # mean dense/(in_elems·c_out) when the density is uniform
            avg_touched = dense / (in_elems * layer.out_ch)
            stats.append(dict(kind="conv", dense_macs=float(dense),
                              event_macs=float(events * avg_touched *
                                               layer.out_ch),
                              in_events=float(events),
                              in_elems=float(in_elems), c_out=layer.out_ch,
                              avg_touched=float(avg_touched),
                              out_density=density_profile[
                                  min(li + 1, len(density_profile) - 1)]))
        elif isinstance(layer, FCSpec):
            in_elems = h * w * c
            events = in_elems * d
            stats.append(dict(kind="fc",
                              dense_macs=float(in_elems * layer.out),
                              event_macs=float(events * layer.out),
                              in_events=float(events),
                              in_elems=float(in_elems), c_out=layer.out,
                              avg_touched=1.0,
                              out_density=density_profile[
                                  min(li + 1, len(density_profile) - 1)]))
        li += 1
    return stats
