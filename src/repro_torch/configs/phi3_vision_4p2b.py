"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (MHA kv=32) d_ff=8192
vocab=32064 — phi3-mini backbone + CLIP frontend (stub: precomputed patch
embeddings).  [hf:microsoft/Phi-3-vision-128k-instruct; hf]
"""
from repro_torch.configs.base import MNFConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm",
        num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=32064, head_dim=96,
        act="silu_glu",
        vision_tokens=144,
        mnf=MNFConfig(enabled=True, threshold=0.0, magnitude=True),
        fsdp=True, sub_quadratic=False,
    )
