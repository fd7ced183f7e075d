"""repro_torch.engine — the MNF event-pipeline engine (DESIGN.md §3–§5), port
of ``repro.engine``: one config, one backend registry, one inter-layer
currency (:class:`EventStream`)::

    from repro_torch import engine
    cfg = engine.EngineConfig()                 # backend from the device
    s = engine.fire(engine.linear(x, w1, cfg=cfg), cfg)
    y = engine.linear(s, w2, cfg=cfg)           # chained, no re-encode
"""
from repro_torch.core.events import (STRIP_CO_MIN, STRIP_STRIDES, STRIP_W,
                                     pool_window_ineligible_reason,
                                     retile_ineligible_reason, strip_eligible,
                                     strip_ineligible_reason)
from repro_torch.costmodel.crossover import linear_shape_class
from repro_torch.engine.api import (conv2d, describe, fire, fire_conv,
                                    fire_delta, linear, matmul, maxpool2d,
                                    pool_ineligible_reason, route_conv,
                                    route_linear, route_pool,
                                    route_recurrent,
                                    recurrent_ineligible_reason,
                                    recurrent_step, sparsify)
from repro_torch.engine.config import BACKENDS, RECURRENT_BLK_K, EngineConfig
from repro_torch.engine.registry import (dispatch, get_backend, list_backends,
                                         register_backend)
from repro_torch.engine.stream import EventStream
from repro_torch.engine.trace import trace_dispatch

import repro_torch.engine.backends  # noqa: F401,E402  (registers backends)

__all__ = [
    "BACKENDS", "RECURRENT_BLK_K", "EngineConfig", "EventStream",
    "STRIP_CO_MIN",
    "STRIP_STRIDES", "STRIP_W", "strip_eligible", "strip_ineligible_reason",
    "pool_window_ineligible_reason", "retile_ineligible_reason",
    "linear_shape_class", "register_backend", "get_backend", "dispatch",
    "list_backends", "matmul", "linear", "conv2d",
    "maxpool2d", "pool_ineligible_reason", "route_conv", "route_pool",
    "route_linear", "route_recurrent", "fire", "fire_conv", "fire_delta",
    "recurrent_ineligible_reason", "recurrent_step", "sparsify",
    "describe", "trace_dispatch",
]
