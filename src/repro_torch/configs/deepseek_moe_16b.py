"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE: 2 shared + 64 routed top-6, fine-grained.
[arXiv:2401.06066; hf]
"""
from repro_torch.configs.base import MNFConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=102400, head_dim=128,
        act="silu_glu",
        moe=MoEConfig(num_experts=64, num_shared=2, top_k=6,
                      expert_ff=1408, first_dense_layers=1,
                      dense_ff=10944),
        mnf=MNFConfig(enabled=True, threshold=0.0, magnitude=True),
        fsdp=True, sub_quadratic=False,
    )
