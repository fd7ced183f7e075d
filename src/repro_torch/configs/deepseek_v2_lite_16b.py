"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408
vocab=102400, MLA kv_lora=512, 2 shared + 64 routed top-6.
[arXiv:2405.04434; hf]
"""
from repro_torch.configs.base import (MLAConfig, MNFConfig, ModelConfig,
                                      MoEConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=102400, head_dim=128,
        act="silu_glu",
        moe=MoEConfig(num_experts=64, num_shared=2, top_k=6,
                      expert_ff=1408, first_dense_layers=1,
                      dense_ff=10944),
        mla=MLAConfig(kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128,
                      v_head_dim=128),
        mnf=MNFConfig(enabled=True, threshold=0.0, magnitude=True),
        fsdp=True, sub_quadratic=False,
    )
