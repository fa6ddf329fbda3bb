"""Operational-intensity layer classification -> M2Q policy (twin of
``repro.core.policy``; pure Python).

PWConv/MatMul are computation-intensive -> mixed uniform8/APoT; DWConv is
memory-intensive -> 4-bit uniform.  A dense layer's intensity is computed
under the deployment shape (tokens per step)."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

KIND_DENSE = "dense"          # matmul / PWConv (1x1 conv)
KIND_DWCONV = "dwconv"        # depthwise conv
KIND_EMBEDDING = "embedding"  # gather-dominated
KIND_HEAD = "head"            # vocab projection
KIND_EXPERT = "expert"        # MoE expert matmul
KIND_SKIP = "skip"            # norms, gates: left unquantized

DECISION_MIXED = "mixed"
DECISION_LOWBIT = "lowbit"
DECISION_SKIP = "skip"


@dataclasses.dataclass(frozen=True)
class ShapeCtx:
    """Deployment shape: how many tokens flow through a weight per step."""

    tokens_per_step: int
    moe_top_k: int = 1
    moe_num_experts: int = 1

    @property
    def tokens_per_expert(self) -> float:
        return (self.tokens_per_step * self.moe_top_k
                / max(self.moe_num_experts, 1))


@dataclasses.dataclass(frozen=True)
class M2QPolicy:
    """The two-level mixed quantization policy (paper Sec. III-B)."""

    compute_scheme: str = "m2q"   # "m2q" | "uniform8" | "apot"
    memory_bits: int = 4
    apot_ratio: Optional[float] = 0.5  # 1:1 APoT:uniform; None = Eq. 6 argmin
    act_bits: int = 8
    quantize_activations: bool = True
    intensity_threshold: float = 64.0  # FLOPs/byte, memory vs compute


@dataclasses.dataclass(frozen=True)
class PathOverride:
    """Per-path override (regex-matched); unset fields fall through."""

    decision: Optional[str] = None
    scheme: Optional[str] = None
    bits: Optional[int] = None

    def __post_init__(self):
        if self.decision not in (None, DECISION_MIXED, DECISION_LOWBIT,
                                 DECISION_SKIP):
            raise ValueError(f"unknown decision override {self.decision!r}")
        if self.scheme not in (None, "m2q", "uniform8", "apot"):
            raise ValueError(f"unknown scheme override {self.scheme!r}")
        if self.bits is not None and not 3 <= self.bits <= 8:
            raise ValueError(f"bits override {self.bits!r} outside 3..8")


def dense_intensity(k: int, n: int, tokens: float, weight_bits: int = 8,
                    act_bytes: int = 2) -> float:
    """FLOPs/byte of y[T,N] = x[T,K] @ w[K,N]."""
    flops = 2.0 * tokens * k * n
    bytes_moved = (weight_bits / 8.0) * k * n + act_bytes * tokens * (k + n)
    return flops / max(bytes_moved, 1.0)


def decide(kind: str, shape: tuple, ctx: ShapeCtx, policy: M2QPolicy) -> str:
    """Classify one weight -> DECISION_*."""
    if kind == KIND_SKIP:
        return DECISION_SKIP
    if kind in (KIND_EMBEDDING, KIND_DWCONV):
        # structurally memory-intensive regardless of tokens_per_step
        return DECISION_LOWBIT
    if kind in (KIND_DENSE, KIND_HEAD, KIND_EXPERT):
        k = int(math.prod(shape[:-1]))
        n = int(shape[-1])
        toks = (ctx.tokens_per_expert if kind == KIND_EXPERT
                else ctx.tokens_per_step)
        inten = dense_intensity(k, n, toks)
        return (DECISION_MIXED if inten >= policy.intensity_threshold
                else DECISION_LOWBIT)
    raise ValueError(f"unknown layer kind: {kind}")
