"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads; SWA everywhere except
3 global layers (first/middle/last).  [arXiv:2411.13676; hf]
"""
from repro_torch.configs.base import MNFConfig, ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
        d_ff=5504, vocab_size=32001, head_dim=64,
        block_type="hymba", act="silu_glu",
        sliding_window=1024, layer_pattern="listed",
        global_layer_ids=(0, 15, 31),
        ssm=SSMConfig(state_dim=16, conv_dim=4, expand=1),
        mnf=MNFConfig(enabled=True, threshold=0.0, magnitude=True),
        fsdp=False,
        # SWA + constant SSM state: runs long_500k (global layers use a
        # bounded 32k sink window at 500k).
        sub_quadratic=True,
    )
