"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — GQA, QKV bias.  [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import MNFConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense",
        num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
        d_ff=8960, vocab_size=151936, head_dim=128,
        qkv_bias=True, act="silu_glu", rope_theta=1e6,
        mnf=MNFConfig(enabled=True, threshold=0.0, magnitude=True),
        fsdp=False, sub_quadratic=False,
    )
