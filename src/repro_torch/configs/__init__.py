"""Architecture configs the port serves: ``get_config("<arch-id>")``.

Every architecture of the JAX package's registry, in its order: the
decoder-only LMs, the encoder-decoder whisper-base (its audio frames go
through ``transformer._encode_audio``) and the vision-language
phi-3-vision (patch embeddings in its leading positions).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (GLOBAL_WINDOW, SHAPES, MLAConfig,
                                      MNFConfig, ModelConfig, MoEConfig,
                                      ShapeConfig, SSMConfig)

_REGISTRY = {
    "qwen2-1.5b": "repro_torch.configs.qwen2_1p5b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0p5b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "phi-3-vision-4.2b": "repro_torch.configs.phi3_vision_4p2b",
    "hymba-1.5b": "repro_torch.configs.hymba_1p5b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
}

#: The architectures the port serves, in the JAX registry's order.
ARCH_IDS = tuple(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; served: {sorted(_REGISTRY)}")
    return importlib.import_module(_REGISTRY[arch]).config()


__all__ = ["ARCH_IDS", "GLOBAL_WINDOW", "SHAPES", "MLAConfig",
           "MNFConfig", "ModelConfig", "MoEConfig", "ShapeConfig",
           "SSMConfig", "get_config"]
