"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 — local+global alternating, logit softcap.
[arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import MNFConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b", family="dense",
        num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16,
        d_ff=36864, vocab_size=256000, head_dim=128,
        act="gelu_glu",
        sliding_window=4096, layer_pattern="alternating",
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        post_block_norm=True, tie_embeddings=True,
        mnf=MNFConfig(enabled=True, threshold=0.0, magnitude=True),
        fsdp=True, sub_quadratic=False,
    )
