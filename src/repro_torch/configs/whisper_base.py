"""whisper-base [audio] — 6L d_model=512 8H d_ff=2048 vocab=51865 —
enc-dec, conv frontend (stub: precomputed frame embeddings).
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import MNFConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio",
        num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
        d_ff=2048, vocab_size=51865, head_dim=64,
        act="gelu",  # whisper MLP: gelu, no GLU
        encoder_decoder=True, enc_layers=6, enc_frames=1500,
        mnf=MNFConfig(enabled=True, threshold=0.0, magnitude=True),
        fsdp=False, sub_quadratic=False,
    )
