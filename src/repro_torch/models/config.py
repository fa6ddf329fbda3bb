"""Architecture config (the vision, dense-LM, MoE-LM, recurrent and
encoder-decoder subset of ``repro.models.config``'s ``ArchConfig``, the
VLM stub frontend's ``n_patches`` included; the sharding and execution
fields come with those, and ``block_pattern`` never: JAX's
recurrentgemma takes its pattern from the layer index and never reads
it)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense_lm | moe_lm | rwkv | recurrentgemma | whisper |
                 # efficientvit
    n_layers: int
    d_model: int
    # language models
    vocab_size: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 128
    d_ff: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    ffn: str = "swiglu"  # swiglu | relu2
    rope_theta: float = 10000.0
    norm: str = "rms"  # rms | layer
    # MoE (moe_lm): experts per layer, experts a token takes, the expert
    # FFN width (0: d_ff), a shared SwiGLU expert beside them, and the
    # dispatch buffer's capacity factor
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_shared_expert: bool = False
    moe_capacity_factor: float = 1.25
    window: Optional[int] = None  # sliding attention window (None: all)
    # recurrentgemma: the RG-LRU width (0: d_model) and the temporal
    # conv's width
    lru_width: int = 0
    conv1d_width: int = 4
    # rwkv: the time-mix head width
    rwkv_head_dim: int = 64
    # encoder-decoder (whisper): n_layers = decoder layers; the encoder's
    # layers (0: n_layers) and its frames
    n_enc_layers: int = 0
    n_audio_ctx: int = 1500
    kv_cache_dtype: str = "bf16"  # bf16 | int8 (per-row scales, integer
                                  # decode attention)
    # vlm stub frontend: patch embeddings prepended to the tokens
    n_patches: int = 0
    # efficientvit (vision)
    widths: Tuple[int, ...] = ()
    depths: Tuple[int, ...] = ()
    img_res: int = 224
    n_classes: int = 1000
    dim_per_head: int = 16  # EfficientViT MSA head dim
    # numerics: the activation dtype of the forward
    dtype: str = "bfloat16"

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 (even per shard; int4 nibble
        packing needs even filter counts)."""
        return round_up(self.vocab_size, 128)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
