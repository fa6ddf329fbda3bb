"""Decoder-only transformer LM (twin of ``repro.models.dense_lm``):
qwen1.5-0.5b (QKV bias, MHA), qwen3-14b (qk_norm, GQA), granite-3-8b
(GQA), minitron-4b (GQA, squared-ReLU FFN), internvl2-2b (GQA; its stub
frontend's patch embeddings enter :func:`forward` and :func:`prefill` as
``prefix_embeds``, ahead of the tokens) and the MoE variants
(``cfg.moe_experts > 0``, family ``moe_lm``): llama4-scout (16 experts,
top-1, a shared expert) and dbrx (16 experts, top-4).  An MoE layer's
FFN is ``nn.moe_ffn`` over the layer's tokens flattened to (B * S, D) --
pad positions of a right-padded prefill included, taking capacity as in
JAX -- plus the shared expert's SwiGLU.

Layer parameters are stacked along a leading L axis, as in the JAX
package, and run by a Python loop over :func:`layer_params` slices (JAX
scans them).  A slice of a stacked QTensor leaf keeps the leaf's ``axis``
and ``shape`` (``core.qtensor.slice_layer``), so the kernel routing of
``kernels.ops`` sees what JAX's sees inside its scan.

KV caches are stacked ``(L, B, T, Hkv, D)``: bf16/f32 rows, or int8 rows
with ``(L, B, T, Hkv)`` f32 row scales when ``kv_cache_dtype == "int8"``
(then every decode step's attention is the ``decode_attn_int8`` kernel).
Where JAX returns a new cache, the port writes the rows of the cache it
is given in place and returns it with the new ``lengths``; a write whose
row lies past ``max_len`` is dropped, as JAX drops an out-of-bounds
scatter.
"""
from __future__ import annotations

from functools import partial

import torch

from .. import nn
from ..core import policy as pol
from ..core.qtensor import slice_layer
from ..core.tree import leaves_with_path, map_with_path, unflatten
from .config import ArchConfig

# perm-foldable FFN filter groups: (up, gate|None, down) path regexes
FFN_FOLD_GROUPS = [
    (r"layers/mlp/w1$", r"layers/mlp/w3$", r"layers/mlp/w2$"),   # swiglu
    (r"layers/mlp/w1$", None, r"layers/mlp/w2$"),                # relu2
    (r"layers/shared/w1$", r"layers/shared/w3$", r"layers/shared/w2$"),
]

# prefill() takes per-row lengths of right-padded prompts: positions at or
# past a row's length are masked by decode attention, and causality keeps
# them out of every valid row during the prefill itself
RAGGED_PREFILL = True

# quantization rules: path regex -> layer kind (first match wins)
QUANT_RULES = [
    (r"embed", pol.KIND_EMBEDDING),
    (r"lm_head", pol.KIND_HEAD),
    (r"experts/", pol.KIND_EXPERT),
    (r"router", pol.KIND_SKIP),
    (r"(ln|norm|gamma|scale|bias|b_)", pol.KIND_SKIP),
    (r"attn/w[qkvo]$", pol.KIND_DENSE),
    (r"(mlp|shared)/w\d$", pol.KIND_DENSE),
]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Float parameters from a torch generator seeded with ``seed``: the
    JAX package's tree, shapes and laws (lecun-normal matrices per layer,
    truncated-normal embedding, zero biases, unit norms), other numbers.
    On ``device="meta"`` every leaf is shape-only (the port's
    ``jax.eval_shape`` of init)."""
    if cfg.family not in ("dense_lm", "moe_lm"):
        raise NotImplementedError(f"{cfg.family!r}: only dense_lm and "
                                  "moe_lm are ported")
    device = torch.device(device)
    g = nn.generator(seed, device)
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff

    def stacked(shape):
        return nn.stacked(L, shape, nn.lecun_normal, g, device)

    def fill(value, shape):
        return torch.full((L,) + shape, value, dtype=torch.float32,
                          device=device)

    attn = {"wq": stacked((D, cfg.q_dim)), "wk": stacked((D, cfg.kv_dim)),
            "wv": stacked((D, cfg.kv_dim)), "wo": stacked((cfg.q_dim, D))}
    if cfg.qkv_bias:
        attn.update(bq=fill(0.0, (cfg.q_dim,)), bk=fill(0.0, (cfg.kv_dim,)),
                    bv=fill(0.0, (cfg.kv_dim,)))
    if cfg.qk_norm:
        attn.update(q_gamma=fill(1.0, (cfg.head_dim,)),
                    k_gamma=fill(1.0, (cfg.head_dim,)))
    layers = {"ln1": fill(1.0, (D,)), "ln2": fill(1.0, (D,)), "attn": attn}
    if cfg.moe_experts:  # router (L, D, E), experts (L, E, D, Fm) ...
        E, Fm = cfg.moe_experts, cfg.moe_d_ff or F
        layers["moe"] = {
            "router": stacked((D, E)),
            "experts": {"w1": stacked((E, D, Fm)), "w3": stacked((E, D, Fm)),
                        "w2": stacked((E, Fm, D))}}
        if cfg.moe_shared_expert:
            layers["shared"] = {"w1": stacked((D, Fm)),
                                "w3": stacked((D, Fm)),
                                "w2": stacked((Fm, D))}
    elif cfg.ffn == "relu2":
        layers["mlp"] = {"w1": stacked((D, F)), "w2": stacked((F, D))}
    else:  # swiglu
        layers["mlp"] = {"w1": stacked((D, F)), "w3": stacked((D, F)),
                         "w2": stacked((F, D))}
    return {
        "embed": nn.trunc_normal((cfg.padded_vocab, D), g, device),
        "layers": layers,
        "final_norm": torch.ones((D,), device=device),
        "lm_head": nn.lecun_normal((D, cfg.padded_vocab), g, device),
    }


def layer_params(layers, i: int):
    """Layer ``i`` of the stacked ``params["layers"]`` tree."""
    return map_with_path(lambda _, leaf: slice_layer(leaf, i), layers)


def layer_stack(layers, n: int) -> list:
    """``[layer_params(layers, i) for i in range(n)]``, each float leaf
    unbound once: one autograd node whose backward stacks the layers'
    gradients, where ``n`` slices would each write a zero-filled copy of
    the whole stack in the backward.  The same views either way."""
    slices = [leaf.unbind(0) if isinstance(leaf, torch.Tensor)
              else [slice_layer(leaf, i) for i in range(n)]
              for _, leaf in leaves_with_path(layers)]
    return [unflatten(layers, [s[i] for s in slices]) for i in range(n)]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _qk_rms_norm(x, gamma, eps: float = 1e-6):
    """Per-head RMS norm over the head dim (qk_norm)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * gamma.to(torch.float32)).to(x.dtype)


def _qkv(cfg: ArchConfig, lp, x, positions):
    a = lp["attn"]
    q = nn.dense(x, a["wq"], a.get("bq"))
    k = nn.dense(x, a["wk"], a.get("bk"))
    v = nn.dense(x, a["wv"], a.get("bv"))
    B, S = x.shape[0], x.shape[1]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = _qk_rms_norm(q, a["q_gamma"])
        k = _qk_rms_norm(k, a["k_gamma"])
    q = nn.apply_rope(q, positions, cfg.rope_theta)
    k = nn.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def moe_config(cfg: ArchConfig) -> nn.MoEConfig:
    return nn.MoEConfig(num_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
                        d_model=cfg.d_model, d_ff=cfg.moe_d_ff or cfg.d_ff,
                        capacity_factor=cfg.moe_capacity_factor)


def _ffn(cfg: ArchConfig, lp, x):
    if cfg.moe_experts:
        B, S, D = x.shape
        y = nn.moe_ffn(x.reshape(B * S, D), lp["moe"],
                       moe_config(cfg)).reshape(B, S, D)
        if cfg.moe_shared_expert:
            s = lp["shared"]
            y = y + nn.swiglu(x, s["w1"], s["w3"], s["w2"])
        return y
    m = lp["mlp"]
    if cfg.ffn == "relu2":
        return nn.dense(torch.square(torch.relu(nn.dense(x, m["w1"]))),
                        m["w2"])
    return nn.swiglu(x, m["w1"], m["w3"], m["w2"])


def block(cfg: ArchConfig, lp, x, positions):
    h = nn.rms_norm(x, lp["ln1"])
    q, k, v = _qkv(cfg, lp, h, positions)
    o = nn.flash_attention(q, k, v, causal=True, window=cfg.window)
    x = x + nn.dense(o.reshape(*x.shape[:2], cfg.q_dim), lp["attn"]["wo"])
    return x + _ffn(cfg, lp, nn.rms_norm(x, lp["ln2"]))


def decode_rows(lengths: torch.Tensor, T: int):
    """Where a decode step writes each slot's new cache row: ``(slot
    index, row, in range)`` for row ``lengths - 1``.  A row past the
    cache is out of range; its write is dropped (computed once a step,
    shared by every layer's writes)."""
    at = (lengths - 1).to(torch.int64)
    ok = at < T
    safe = torch.where(ok, at, torch.zeros_like(at))
    return torch.arange(at.shape[0], device=at.device), safe, ok


def _write_rows(dst: torch.Tensor, rows: torch.Tensor, where) -> None:
    """``dst[b, lengths[b] - 1] = rows[b]`` in place where in range; an
    out-of-range slot gets the row it already holds written back, so its
    write is dropped with no host sync."""
    bidx, safe, ok = where
    mask = ok.reshape((-1,) + (1,) * (rows.ndim - 1))
    dst[bidx, safe] = torch.where(mask, rows.to(dst.dtype), dst[bidx, safe])


def block_decode(cfg: ArchConfig, lp, x, kv, lengths, rows):
    """One-token decode through one layer; ``kv`` holds the layer's cache
    views, written in place at row ``lengths - 1`` (``rows``: the step's
    :func:`decode_rows`)."""
    B = x.shape[0]
    h = nn.rms_norm(x, lp["ln1"])
    q, k, v = _qkv(cfg, lp, h, (lengths - 1)[:, None])
    if cfg.kv_cache_dtype == "int8":
        k8, ks = nn.quantize_kv_rows(k[:, 0])
        v8, vs = nn.quantize_kv_rows(v[:, 0])
        for name, new in (("k", k8), ("v", v8), ("k_scale", ks),
                          ("v_scale", vs)):
            _write_rows(kv[name], new, rows)
        o = nn.decode_attention_int8(q, kv["k"], kv["v"], kv["k_scale"],
                                     kv["v_scale"], lengths,
                                     window=cfg.window)
    else:
        _write_rows(kv["k"], k[:, 0], rows)
        _write_rows(kv["v"], v[:, 0], rows)
        o = nn.decode_attention(q, kv["k"], kv["v"], lengths,
                                window=cfg.window)
    x = x + nn.dense(o.reshape(B, 1, cfg.q_dim), lp["attn"]["wo"])
    return x + _ffn(cfg, lp, nn.rms_norm(x, lp["ln2"]))


# ---------------------------------------------------------------------------
# forward / cache / decode / prefill
# ---------------------------------------------------------------------------


def _embed(cfg: ArchConfig, params, tokens, prefix_embeds=None):
    """Token embeddings in ``cfg.dtype``, after ``prefix_embeds`` (B, P,
    d_model) where given (the VLM stub frontend: internvl2)."""
    dtype = getattr(torch, cfg.dtype)
    x = nn.embed(tokens, params["embed"]).to(dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(device=x.device, dtype=dtype), x],
                      dim=1)
    return x


def forward(cfg: ArchConfig, params, tokens: torch.Tensor,
            prefix_embeds=None, remat: bool = True,
            remat_policy: str = "full") -> torch.Tensor:
    """tokens (B, S), after ``prefix_embeds`` (B, P, d_model) if given ->
    logits (B, P + S, padded_vocab) in ``cfg.dtype``.  While autograd
    records, each layer's activations are recomputed in the backward
    (``remat``; ``remat_policy`` "full" or "dots", JAX's
    ``cfg.remat_policy``); under ``torch.no_grad()`` it is a plain loop."""
    x = _embed(cfg, params, tokens, prefix_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for lp in layer_stack(params["layers"], cfg.n_layers):
        if remat:
            x = nn.remat(partial(block, cfg), lp, x, positions,
                         policy=remat_policy)
        else:
            x = block(cfg, lp, x, positions)
    x = nn.rms_norm(x, params["final_norm"])
    return nn.dense(x, params["lm_head"])


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """An empty stacked cache; ``dtype`` is the row type of a float
    cache."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=device)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], device=device),
                "v_scale": torch.zeros(shape[:-1], device=device),
                "lengths": lengths}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "lengths": lengths}


def _layer_cache(cache: dict, i: int) -> dict:
    return {k: v[i] for k, v in cache.items() if k != "lengths"}


def decode_step(cfg: ArchConfig, params, cache: dict, tokens: torch.Tensor):
    """tokens (B, 1) -> (logits (B, 1, padded_vocab), cache with the new
    rows written and ``lengths + 1``).  Every slot advances, idle ones
    too; their rows past ``max_len`` are dropped."""
    lengths = cache["lengths"] + 1  # include the new token
    rows = decode_rows(lengths, cache["k"].shape[2])
    x = _embed(cfg, params, tokens)
    for i in range(cfg.n_layers):
        x = block_decode(cfg, layer_params(params["layers"], i), x,
                         _layer_cache(cache, i), lengths, rows)
    x = nn.rms_norm(x, params["final_norm"])
    return nn.dense(x, params["lm_head"]), {**cache, "lengths": lengths}


def prefill(cfg: ArchConfig, params, cache: dict, tokens: torch.Tensor,
            prefix_embeds=None, lengths=None):
    """Fill the cache from (B, S) prompts, after ``prefix_embeds`` (B, P,
    d_model) if given; returns (last-token logits (B, 1, padded_vocab),
    cache).  Positions and the cache run over all P + S rows.
    ``lengths`` (B,): ragged sequences (prefix included), right-padded to
    P + S -- the logits are read at ``lengths - 1`` and the cache records
    the true lengths; the pad rows' k/v sit at positions the decode
    masks."""
    x = _embed(cfg, params, tokens, prefix_embeds)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        kv = _layer_cache(cache, i)
        h = nn.rms_norm(x, lp["ln1"])
        q, k, v = _qkv(cfg, lp, h, positions)
        if cfg.kv_cache_dtype == "int8":
            k8, ks = nn.quantize_kv_rows(k)
            v8, vs = nn.quantize_kv_rows(v)
            kv["k"][:, :S] = k8
            kv["v"][:, :S] = v8
            kv["k_scale"][:, :S] = ks
            kv["v_scale"][:, :S] = vs
        else:
            kv["k"][:, :S] = k.to(kv["k"].dtype)
            kv["v"][:, :S] = v.to(kv["v"].dtype)
        o = nn.flash_attention(q, k, v, causal=True, window=cfg.window)
        x = x + nn.dense(o.reshape(B, S, cfg.q_dim), lp["attn"]["wo"])
        x = x + _ffn(cfg, lp, nn.rms_norm(x, lp["ln2"]))
    if lengths is None:
        x_last = x[:, -1:]
        new_lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    else:
        new_lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                      device=x.device)
        idx = torch.arange(B, device=x.device)
        x_last = x[idx, new_lengths.to(torch.int64) - 1][:, None]
    x_last = nn.rms_norm(x_last, params["final_norm"])
    return nn.dense(x_last, params["lm_head"]), {**cache,
                                                 "lengths": new_lengths}
