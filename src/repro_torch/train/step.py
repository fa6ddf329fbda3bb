"""train_step / serve_step builders (twin of ``repro.train.step``).

train_step: CE loss (masked to the unpadded vocab), microbatch gradient
accumulation in f32, optional int8 gradient compression, AdamW update.
Gradients come from autograd over the parameter leaves; the update runs
under ``torch.no_grad()`` and returns new trees, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core.quant import div
from ..core.tree import leaves_with_path, unflatten
from ..models.config import ArchConfig
from ..optim.adamw import AdamW, AdamWState


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """Mean next-token CE in f32; ``logits`` may be vocab-padded (the tail
    is masked to -1e30).  The max is a stop-gradient, as in the
    reference; the label logit is a gather, the same function as the
    reference's one-hot contraction (which exists only to keep the vocab
    sharded under SPMD)."""
    lf = logits.to(torch.float32)
    V = lf.shape[-1]
    valid = torch.arange(V, device=lf.device) < vocab_size
    lf = torch.where(valid, lf, torch.full((), -1e30, device=lf.device))
    m = torch.amax(lf, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    label_logit = torch.gather(lf, -1, labels.to(torch.int64)[..., None])
    return torch.mean(lse - label_logit[..., 0])


def make_loss_fn(cfg: ArchConfig, model) -> Callable:
    """loss_fn(params, batch): predict token t+1 from t; the batch's other
    entries (``frames``, ``prefix_embeds``) go to the forward, and prefix
    positions are excluded from the loss."""
    def loss_fn(params, batch):
        kw = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
        logits = model.forward(cfg, params, batch["tokens"], **kw)
        S = batch["tokens"].shape[1]
        logits = logits[:, -S:]
        return softmax_xent(logits[:, :-1], batch["labels"][:, 1:],
                            cfg.vocab_size)

    return loss_fn


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    grad_compression: bool = False  # int8 round trip of the gradients


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, gradient tree) of ``loss_fn(params, batch)`` by autograd over
    every leaf (a leaf the loss does not reach gets zeros, as JAX's
    gradient does)."""
    leaves = [t.detach().requires_grad_(True)
              for _, t in leaves_with_path(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), unflatten(params, list(grads))


def make_grad_fn(cfg: ArchConfig, model, microbatches: int = 1):
    """grad_fn(params, batch) -> (loss, gradient tree): the train step's
    loss and gradients before compression.  With ``microbatches`` > 1
    the batch axis is split and the microbatches' losses and gradients
    are summed in f32, then divided by their count."""
    loss_fn = make_loss_fn(cfg, model)

    def grad_fn(params, batch):
        if microbatches == 1:
            return value_and_grad(loss_fn, params, batch)
        n = microbatches
        loss_acc = grad_acc = None
        for i in range(n):
            mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, grads = value_and_grad(loss_fn, params, mb)
            gs = [g.to(torch.float32) for _, g in leaves_with_path(grads)]
            if grad_acc is None:
                loss_acc, grad_acc = loss, gs
            else:
                loss_acc = loss_acc + loss
                grad_acc = [a + g for a, g in zip(grad_acc, gs)]
        return (div(loss_acc, float(n)),
                unflatten(params, [div(g, float(n)) for g in grad_acc]))

    return grad_fn


def make_train_step(cfg: ArchConfig, model, opt: AdamW,
                    ts: TrainStepConfig = TrainStepConfig()):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"}), the metrics 0-d tensors on the device:
    :func:`make_grad_fn`'s loss and gradients, their int8 round trip
    with ``grad_compression``, then the AdamW update."""
    grad_fn = make_grad_fn(cfg, model, ts.microbatches)

    def step(params, opt_state: AdamWState, batch):
        loss, grads = grad_fn(params, batch)
        if ts.grad_compression:
            from ..dist.compression import compress_decompress
            grads = compress_decompress(grads)
        params, opt_state, gnorm = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def make_serve_step(cfg: ArchConfig, model):
    """serve_step(params, cache, tokens) -> (logits, cache): one decode
    step."""

    def serve_step(params, cache, tokens):
        return model.decode_step(cfg, params, cache, tokens)

    return serve_step


def make_prefill_step(cfg: ArchConfig, model):
    def prefill_step(params, cache, tokens, **kw):
        return model.prefill(cfg, params, cache, tokens, **kw)

    return prefill_step
