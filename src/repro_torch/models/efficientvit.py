"""EfficientViT (the paper's backbone): MBConvs + lightweight multi-scale
ReLU linear attention (MSA).  Twin of ``repro.models.efficientvit``.

Layer taxonomy (paper Sec. III-A): PWConvs and the MSA MatMuls are
computation-intensive -> mixed uniform8/APoT (KIND_DENSE); DWConvs are
memory-intensive -> 4-bit uniform (KIND_DWCONV).  NHWC throughout; norms
are channel RMS norms and the activation is SiLU, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import nn
from ..core import policy as pol
from ..kernels import ops
from .config import ArchConfig

QUANT_RULES = [
    (r"(ln|norm|gamma|bias|b$)", pol.KIND_SKIP),
    (r"(w_dw|w_agg)", pol.KIND_DWCONV),
    (r"(w_pw\d?|w_in|w_out|w_qkv|w_proj)", pol.KIND_DENSE),
    (r"head/w", pol.KIND_DENSE),
]

# the Sec. III-A split is structural: pin every dense-kind path to the
# mixed decision whatever the deployment shape
QUANT_OVERRIDES = (
    (r"(w_pw\d?|w_in|w_out|w_qkv|w_proj|head/w)",
     pol.PathOverride(decision=pol.DECISION_MIXED)),
)

# Opt-in int8 stem: QUANT_RULES leave the 3x3 cin=3 stem float; a recipe
# may quantize it to uniform-8 W8A8 and run it as im2col + int8 matmul:
#
#     rec = PRESETS["m2q-w8a8"].replace(
#         rules=tuple(QUANT_RULES) + (STEM_RULE,),
#         overrides=(STEM_OVERRIDE,))
#
# Recipe overrides precede QUANT_OVERRIDES, so the pins above still hold.
STEM_RULE = (r"stem/w$", pol.KIND_DENSE)
STEM_OVERRIDE = (r"stem/w$", pol.PathOverride(decision=pol.DECISION_MIXED,
                                              scheme="uniform8"))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_mbconv(g, device, cin, cout, expand=4):
    mid = cin * expand
    return {
        "w_pw1": nn.lecun_normal((1, 1, cin, mid), g, device),
        "w_dw": nn.lecun_normal((3, 3, 1, mid), g, device),
        "w_pw2": nn.lecun_normal((1, 1, mid, cout), g, device),
        "ln1": torch.ones((mid,), device=device),
        "ln2": torch.ones((cout,), device=device),
    }


def _init_msa(g, device, c):
    d = 3 * c
    return {
        "w_qkv": nn.lecun_normal((1, 1, c, d), g, device),
        "w_agg": nn.lecun_normal((5, 5, 1, d), g, device),
        "w_proj": nn.lecun_normal((1, 1, 2 * c, c), g, device),
        "ln": torch.ones((c,), device=device),
    }


def init(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Float parameters from a torch generator seeded with ``seed`` (same
    tree and same lecun_normal law as the JAX package, other numbers).
    On ``device="meta"`` every leaf is shape-only (the port's
    ``jax.eval_shape`` of init)."""
    device = torch.device(device)
    g = nn.generator(seed, device)
    widths, depths = cfg.widths, cfg.depths
    params = {
        "stem": {"w": nn.lecun_normal((3, 3, 3, widths[0]), g, device),
                 "ln": torch.ones((widths[0],), device=device)},
    }
    cin = widths[0]
    stages = []
    for si, (w, d) in enumerate(zip(widths, depths)):
        blocks = []
        for _ in range(d):
            blk = {"mb": _init_mbconv(g, device, cin, w)}
            if si >= len(widths) - 2:  # the last two stages carry MSA
                blk["msa"] = _init_msa(g, device, w)
            blocks.append(blk)
            cin = w
        stages.append(blocks)
    params["stages"] = stages
    params["head"] = {
        "w_in": nn.lecun_normal((1, 1, cin, cin * 4), g, device),
        "ln": torch.ones((cin * 4,), device=device),
        "w": nn.lecun_normal((cin * 4, cfg.n_classes), g, device),
    }
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _mbconv(p, x, stride=1):
    h = nn.conv2d(x, p["w_pw1"])
    h = nn.silu(nn.rms_norm(h, p["ln1"]))
    h = nn.dwconv2d(h, p["w_dw"], stride=stride)
    h = nn.silu(h)
    h = nn.conv2d(h, p["w_pw2"])
    h = nn.rms_norm(h, p["ln2"])
    if stride == 1 and x.shape[-1] == h.shape[-1]:
        h = h + x
    return h


def _msa(p, x, dim_per_head: int, attn: str):
    B, H, W, C = x.shape
    qkv = nn.conv2d(nn.rms_norm(x, p["ln"]), p["w_qkv"])  # (B,H,W,3C)
    qkv2 = nn.dwconv2d(qkv, p["w_agg"])  # second token scale (5x5)
    nh = C // dim_per_head
    outs = []
    for t in (qkv, qkv2):
        q, k, v = torch.split(t.reshape(B, H * W, 3 * C), C, dim=-1)
        shape = (B, H * W, nh, dim_per_head)
        o = nn.relu_linear_attention(q.reshape(shape), k.reshape(shape),
                                     v.reshape(shape), attn=attn)
        outs.append(o.reshape(B, H, W, C))
    o = torch.cat(outs, dim=-1)  # (B,H,W,2C)
    return x + nn.conv2d(o, p["w_proj"])


def forward(cfg: ArchConfig, params, images: torch.Tensor,
            attn: Optional[str] = None) -> torch.Tensor:
    """images (B, res, res, 3) -> logits (B, n_classes) in ``cfg.dtype``.

    ``attn``: the MSA token mixer, ``"int8"`` (the relu_attn kernel) or
    ``"f32"`` (einsums); None follows the attn dispatch axis
    (:func:`repro_torch.kernels.ops.attn_dispatch_enabled`)."""
    attn = attn or (ops.ATTN_INT8 if ops.attn_dispatch_enabled(images.device)
                    else ops.ATTN_F32)
    x = images.to(getattr(torch, cfg.dtype))
    x = nn.conv2d(x, params["stem"]["w"], stride=2)
    x = nn.silu(nn.rms_norm(x, params["stem"]["ln"]))
    for si, blocks in enumerate(params["stages"]):
        for bi, blk in enumerate(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            x = _mbconv(blk["mb"], x, stride=stride)
            if "msa" in blk:
                x = _msa(blk["msa"], x, cfg.dim_per_head, attn)
    x = nn.conv2d(x, params["head"]["w_in"])
    x = nn.silu(nn.rms_norm(x, params["head"]["ln"]))
    x = torch.mean(x, dim=(1, 2))  # global pool
    return nn.dense(x, params["head"]["w"])
