"""NN substrate on plain tensors and nested-dict parameters."""
from .attention import relu_linear_attention
from .layers import conv2d, dense, dwconv2d, lecun_normal, rms_norm, silu

__all__ = ["conv2d", "dense", "dwconv2d", "lecun_normal", "rms_norm",
           "silu", "relu_linear_attention"]
