"""Config system — the port's copy of ``repro.configs.base``: one dataclass
tree describes every architecture, with the exact published numbers;
reduced smoke variants come from :meth:`ModelConfig.reduced`.

The port serves the configurations whose block types it has ported
(``configs.get_config``); the dataclasses' fields are copied whole, so a
config built here equals the JAX package's field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["MoEConfig", "MLAConfig", "SSMConfig", "MNFConfig", "ModelConfig",
           "ShapeConfig", "GLOBAL_WINDOW"]

# Sentinel window meaning "global attention" in per-layer window arrays.
GLOBAL_WINDOW = 1 << 30


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int               # routed experts
    num_shared: int                # shared (always-on) experts
    top_k: int
    expert_ff: int                 # per-expert FFN hidden size
    first_dense_layers: int = 1    # leading layers use a dense FFN
    dense_ff: int = 0              # hidden size of those dense FFNs
    capacity_factor: float = 1.25
    router_renormalize: bool = False  # renormalize top-k gate weights


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_dim: int = 4
    expand: int = 2
    dt_rank: int = 0               # 0 -> ceil(d_model / 16)
    scan_chunk: int = 512          # time-chunked scan (memory-bounded)


@dataclasses.dataclass(frozen=True)
class MNFConfig:
    """Multiply-and-Fire integration (the paper's technique as a feature).

    ``use_pallas`` is kept for parity with the JAX package and has no
    meaning in the port: the engine picks its kernels from the device of
    the tensors (``EngineConfig.from_mnf`` gives backend "auto")."""

    enabled: bool = False
    threshold: float = 0.0         # fire threshold (0 == exact for ReLU nets)
    magnitude: bool = True         # |a| > θ (LM generalization)
    blk_m: int = 8                 # event tile rows
    blk_k: int = 128               # event tile K
    use_pallas: bool = False       # parity field, unused by the port


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | ssm | moe | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    block_type: str = "attn"       # attn | rwkv6 | hymba
    qkv_bias: bool = False
    act: str = "silu_glu"          # silu_glu | gelu_glu | relu2 | relu | gelu
    # --- attention pattern ---
    sliding_window: Optional[int] = None  # window for local layers
    layer_pattern: str = "all_global"     # all_global | alternating | listed
    global_layer_ids: tuple = ()          # for layer_pattern == "listed"
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    post_block_norm: bool = False          # gemma2 sandwich norms
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- submodules ---
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # --- enc-dec / multimodal stubs ---
    encoder_decoder: bool = False
    enc_layers: int = 0
    enc_frames: int = 0            # whisper: precomputed frame embeddings
    vision_tokens: int = 0         # phi-3-vision: precomputed patch embeds
    # --- MNF ---
    mnf: MNFConfig = dataclasses.field(default_factory=MNFConfig)
    # --- distribution / memory ---
    fsdp: bool = False             # shard params+optimizer over data axis
    seq_shard: bool = True         # SP: shard residual stream over model
    moe_dispatch_groups: int = 32  # group-local MoE dispatch (≥ dp shards)
    moe_ep: bool = False           # explicit expert parallelism
    remat: str = "full"            # full | dots | none
    scan_layers: bool = True
    xent_chunk: int = 1024         # chunked softmax-xent sequence chunk
    attn_chunk: int = 1024         # flash-attention kv chunk
    wkv_chunk: int = 32            # rwkv6 chunk length (prefill)
    # --- capability flags ---
    sub_quadratic: bool = False    # can run long_500k
    has_decoder: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # ---- derived ----
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def window_for_layer(self, i: int) -> int:
        """Per-layer attention window (GLOBAL_WINDOW = full context)."""
        if self.block_type == "rwkv6":
            return 0
        if self.layer_pattern == "all_global" or self.sliding_window is None:
            return GLOBAL_WINDOW
        if self.layer_pattern == "alternating":
            # gemma2: even layers local, odd layers global
            return self.sliding_window if i % 2 == 0 else GLOBAL_WINDOW
        if self.layer_pattern == "listed":
            return (GLOBAL_WINDOW if i in self.global_layer_ids
                    else self.sliding_window)
        raise ValueError(self.layer_pattern)

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        changes = dict(
            num_layers=min(self.num_layers, 2),
            d_model=64, num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2)
            if self.num_kv_heads < self.num_heads else 4,
            d_ff=128, vocab_size=256, head_dim=16,
            enc_layers=min(self.enc_layers, 2),
            enc_frames=min(self.enc_frames, 16) if self.enc_frames else 0,
            vision_tokens=min(self.vision_tokens, 8) if self.vision_tokens
            else 0,
            xent_chunk=16, attn_chunk=32, wkv_chunk=8,
            sliding_window=8 if self.sliding_window else None,
            global_layer_ids=(0,) if self.layer_pattern == "listed" else (),
            fsdp=False,
        )
        if self.moe is not None:
            # capacity_factor high enough that reduced configs never drop
            # tokens (full configs keep the production 1.25).
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=4, num_shared=1, top_k=2, expert_ff=32,
                dense_ff=128, capacity_factor=16.0,
                first_dense_layers=min(1, self.moe.first_dense_layers))
        if self.mla is not None:
            changes["mla"] = MLAConfig(kv_lora_rank=32, qk_rope_dim=8,
                                       qk_nope_dim=16, v_head_dim=16)
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(self.ssm, state_dim=4)
        changes.update(overrides)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


#: The cells of the JAX package's dry run (``repro.configs.base.SHAPES``):
#: the shapes ``launch.roofline.model_flops`` and ``launch.report`` read.
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
