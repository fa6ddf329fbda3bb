"""NN substrate on plain tensors and nested-dict parameters."""
from .attention import (apply_rope, decode_attention, decode_attention_int8,
                        flash_attention, quantize_kv_rows,
                        relu_linear_attention, rope_freqs)
from .layers import (conv2d, dense, dwconv2d, embed, gelu, geglu, generator,
                     layer_norm, lecun_normal, remat, rms_norm, silu,
                     stacked, swiglu, tied_head, trunc_normal)
from .moe import (MoEConfig, aux_load_balance_loss, capacity, expert_dense,
                  expert_ffn, moe_ffn)
from .ssm import (rg_lru, rg_lru_gates, rg_lru_step, rwkv6_attend,
                  rwkv6_attend_step, rwkv6_channelmix, rwkv6_decay,
                  rwkv6_timemix_inputs, temporal_conv1d)

__all__ = ["conv2d", "dense", "dwconv2d", "embed", "gelu", "geglu",
           "generator", "layer_norm", "lecun_normal", "remat", "rms_norm",
           "silu",
           "stacked", "swiglu", "tied_head", "trunc_normal",
           "relu_linear_attention", "apply_rope",
           "rope_freqs", "flash_attention", "decode_attention",
           "decode_attention_int8", "quantize_kv_rows", "MoEConfig",
           "aux_load_balance_loss", "capacity", "expert_dense",
           "expert_ffn", "moe_ffn", "rg_lru", "rg_lru_gates",
           "rg_lru_step", "rwkv6_attend", "rwkv6_attend_step",
           "rwkv6_channelmix", "rwkv6_decay", "rwkv6_timemix_inputs",
           "temporal_conv1d"]
