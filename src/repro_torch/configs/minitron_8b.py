"""minitron-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000 — pruned nemotron (squared-ReLU FFN).  [arXiv:2407.14679; hf]
"""
from repro_torch.configs.base import MNFConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=16384, vocab_size=256000, head_dim=128,
        act="relu2",  # squared-ReLU: natively sparse -> MNF is exact here
        mnf=MNFConfig(enabled=True, threshold=0.0, magnitude=False),
        fsdp=True, sub_quadratic=False,
    )
