"""Architecture configs the port serves: ``get_config("<arch-id>")``.

The port serves the architectures whose blocks it has ported.  Every other
architecture of the JAX package's registry raises and names the
``ROADMAP.md`` item that brings it.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (GLOBAL_WINDOW, MLAConfig, MNFConfig,
                                      ModelConfig, MoEConfig, ShapeConfig,
                                      SSMConfig)

_REGISTRY = {
    "qwen2-1.5b": "repro_torch.configs.qwen2_1p5b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0p5b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "hymba-1.5b": "repro_torch.configs.hymba_1p5b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
}

#: The architectures the port serves, in the JAX registry's order.
ARCH_IDS = tuple(_REGISTRY)

#: Architectures of the JAX package not served here yet, with the
#: ROADMAP.md item that ports them.
NOT_YET_PORTED = {
    arch: "queue A item 12b: whisper-base and phi-3-vision (the "
          "encoder-decoder and vision inputs, with layer_norm)"
    for arch in ("whisper-base", "phi-3-vision-4.2b")}


def get_config(arch: str) -> ModelConfig:
    if arch in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet; see ROADMAP.md "
            f"{NOT_YET_PORTED[arch]}")
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; served: {sorted(_REGISTRY)}")
    return importlib.import_module(_REGISTRY[arch]).config()


__all__ = ["ARCH_IDS", "GLOBAL_WINDOW", "NOT_YET_PORTED", "MLAConfig",
           "MNFConfig", "ModelConfig", "MoEConfig", "ShapeConfig",
           "SSMConfig", "get_config"]
