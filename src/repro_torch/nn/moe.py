"""Mixture-of-Experts layer (twin of ``repro.nn.moe``): llama4-scout
(top-1) and dbrx (top-4, renormalized gates).

Dispatch is capacity-based and static-shaped, as in the JAX package:
the router's softmax gates pick each token's top-k experts; a token's
k choices take positions within their experts in token-major /
choice-minor order (a cumulative sum); a choice past the expert's
capacity ``C`` is zero-masked and added to the expert's row 0 (zeros
change nothing), and masked again on combine.  The (E * C, D) buffer
then runs every expert's SwiGLU as a batched product and the gated
outputs are gathered back.  No step reads a value back to the host, so
a decode step through this layer captures in a CUDA graph.

Expert weights are float tensors, CalibTensors (calibration records
their input under the layer's ``'<path>@<i>'`` key), QUniform leaves
(the dequantized einsum) or QExpertM2Q leaves (``kernels.ops.
qtensor_expert_matmul``: ``m2q_matmul`` expert by expert on the card).
The router stays float.

On a mesh, a rank's layer is a ``dist.spmd.ExpertParallel`` leaf, which
:func:`moe_ffn` hands the layer to: it routes the step's global rows
(gathered over ``data``) through :func:`dispatch_ffn`, runs its own
experts on the shared buffer and gathers their outputs over ``model``.
JAX's ``constrain_ep`` (a sharding constraint of the dry-run's lowering)
is not ported.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.calibrate import CalibTensor
from ..core.qtensor import QExpertM2Q, is_qtensor
from ..kernels import ops
from .layers import dense, silu


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_model: int
    d_ff: int
    capacity_factor: float = 1.25
    normalize_gates: bool = True  # dbrx-style renormalization of top-k


def expert_dense(xe: torch.Tensor, w) -> torch.Tensor:
    """``y[E, C, N] = xe[E, C, K] @ w[E, K, N]`` for any expert leaf."""
    if isinstance(w, CalibTensor):
        w.record(xe)
        return torch.einsum("eck,ekn->ecn", xe, w.w.to(xe.dtype))
    if isinstance(w, QExpertM2Q):
        return (ops.qtensor_expert_matmul(xe, w)
                if ops.dispatch_enabled(xe.device) else w.expert_matmul(xe))
    if is_qtensor(w):
        return torch.einsum("eck,ekn->ecn", xe, w.dequant(xe.dtype))
    return torch.einsum("eck,ekn->ecn", xe, w.to(xe.dtype))


def expert_ffn(xe: torch.Tensor, params) -> torch.Tensor:
    """SwiGLU expert FFN over the (E, C, D) buffer."""
    h = silu(expert_dense(xe, params["w1"])) * expert_dense(xe, params["w3"])
    return expert_dense(h, params["w2"])


def capacity(tokens: int, cfg: MoEConfig) -> int:
    """Rows per expert: ``tokens * top_k * capacity_factor / E``, rounded
    up to a multiple of 8, at least 8."""
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


def top_k(gates: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest gates per row, largest
    first, equal gates in index order (``jax.lax.top_k``'s tie rule,
    which ``torch.topk`` does not promise): a stable descending sort."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def route(x: torch.Tensor, router, cfg: MoEConfig):
    """The dispatch of x (T, D): (top-k gates (T, K) f32, experts (T, K),
    the flat (T * K,) buffer rows ``slot``, and ``ok``: the choices
    within capacity)."""
    E, K = cfg.num_experts, cfg.top_k
    C = capacity(x.shape[0], cfg)
    logits = dense(x, router).to(torch.float32)  # (T, E)
    gates = torch.softmax(logits, dim=-1)
    top_g, top_e = top_k(gates, K)
    if cfg.normalize_gates and K > 1:
        top_g = top_g / torch.sum(top_g, dim=-1, keepdim=True)
    flat_e = top_e.reshape(-1)  # token-major / choice-minor
    onehot = (flat_e[:, None] == torch.arange(E, device=x.device)).to(
        torch.int32)
    pos = torch.cumsum(onehot, dim=0) - 1  # position within the expert
    pos_in_e = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    ok = pos_in_e < C
    slot = torch.where(ok, flat_e * C + pos_in_e, flat_e * C)
    return top_g, top_e, slot, ok


def moe_ffn(x: torch.Tensor, params, cfg: MoEConfig) -> torch.Tensor:
    """x (T, D) token-flattened activations -> (T, D); ``params`` the
    layer's ``{"router", "experts"}``, or a rank's shard of the layer
    that runs it (``local_moe(x, cfg)``: ``dist.spmd.ExpertParallel``)."""
    if hasattr(params, "local_moe"):
        return params.local_moe(x, cfg)
    experts = params["experts"]
    return dispatch_ffn(x, params["router"], cfg,
                        lambda xe: expert_ffn(xe, experts))


def dispatch_ffn(x: torch.Tensor, router, cfg: MoEConfig,
                 run_experts) -> torch.Tensor:
    """The layer over x (T, D): route, fill the (E, C, D) buffer, run
    ``run_experts`` on it ((E, C, D) -> (E, C, D)), combine."""
    T, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    C = capacity(T, cfg)
    top_g, _, slot, ok = route(x, router, cfg)
    xrep = torch.repeat_interleave(x, K, dim=0)  # (T * K, D)
    xrep = torch.where(ok[:, None], xrep, torch.zeros_like(xrep))
    buf = torch.zeros((E * C, D), dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot, xrep)
    ye = run_experts(buf.reshape(E, C, D))  # (E, C, D)
    yrep = ye.reshape(E * C, D)[slot]  # (T * K, D)
    gates = torch.where(ok, top_g.reshape(-1), torch.zeros_like(
        top_g.reshape(-1)))
    y = torch.sum(yrep.reshape(T, K, D)
                  * gates.reshape(T, K)[..., None].to(ye.dtype), dim=1)
    return y.to(x.dtype)


def aux_load_balance_loss(logits: torch.Tensor, top_e: torch.Tensor,
                          num_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: ``E * sum(mean gate * share of first
    choices)`` per expert."""
    gates = torch.softmax(logits.to(torch.float32), dim=-1)
    me = torch.mean(gates, dim=0)
    first = top_e[:, 0]
    ce = torch.mean((first[:, None] == torch.arange(
        num_experts, device=first.device)).to(torch.float32), dim=0)
    return num_experts * torch.sum(me * ce)
