"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  ``counts()``/``reset_counts()``/``set_counts()`` read, zero and
set the per-kernel launch and plain-call counters."""
from typing import Dict

from . import (apot_matmul, decode_attn_int8, dwconv_w4, int4_matmul,
               int8_matmul, m2q_matmul, relu_attn, relu_attn_scales)

KERNELS = {"m2q_matmul": m2q_matmul, "dwconv_w4": dwconv_w4,
           "relu_attn": relu_attn, "relu_attn_scales": relu_attn_scales,
           "int8_matmul": int8_matmul, "int4_matmul": int4_matmul,
           "apot_matmul": apot_matmul, "decode_attn_int8": decode_attn_int8}


def counts() -> Dict[str, Dict[str, int]]:
    return {name: {"launches": mod.launches, "plain_calls": mod.plain_calls}
            for name, mod in KERNELS.items()}


def reset_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
        mod.plain_calls = 0


def set_counts(c: Dict[str, Dict[str, int]]) -> None:
    """Set every counter to ``c`` (a :func:`counts` reading)."""
    for name, mod in KERNELS.items():
        mod.launches = c[name]["launches"]
        mod.plain_calls = c[name]["plain_calls"]
