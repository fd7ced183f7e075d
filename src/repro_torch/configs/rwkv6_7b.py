"""rwkv6-7b [ssm] — Finch: 32L d_model=4096 (attn-free) d_ff=14336
vocab=65536 — data-dependent decay.  [arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import MNFConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", family="ssm",
        num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
        d_ff=14336, vocab_size=65536, head_dim=64,
        block_type="rwkv6", act="relu2",  # channel-mix uses squared ReLU
        mnf=MNFConfig(enabled=True, threshold=0.0, magnitude=False),
        fsdp=True, sub_quadratic=True,   # constant-size state: runs long_500k
    )
