"""Autograd through the port's models against ``jax.grad`` of the JAX
package's, on the CPU: every family in ``ASSIGNED`` at REDUCED width
(dense, MoE through ``nn/moe``, rwkv and recurrentgemma through
``nn/ssm``, whisper with its encoder) and EfficientViT-B1 REDUCED, on
the inputs of ``tests/test_archs_smoke.py`` and the parameters of JAX's
``init`` carried over by ``repro_torch.convert``: each gradient leaf
within 1e-4 of that leaf's max |g|.  Then rematerialisation
(``nn.remat``): gradients equal with it on and off, and the forward under
``torch.no_grad()`` unchanged -- a plain loop that never enters
``torch.utils.checkpoint``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ASSIGNED
from repro.configs.registry import REDUCED as JREDUCED
from repro.models import get_model as jget_model
from repro_torch.configs.registry import REDUCED as TREDUCED
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.tree import leaves_with_path
from repro_torch.models import dense_lm
from repro_torch.models import get_model as tget_model
from repro_torch.train.step import value_and_grad
from torch_parity import jax_to_numpy

B, S = 2, 16
EFFVIT = "efficientvit-b1-r224"


def _inputs(cfg):
    """tests/test_archs_smoke.py's inputs: tokens and the model's extra
    input (whisper's frames, internvl2's patch embeddings)."""
    rng = np.random.default_rng(0)
    kw = {}
    if cfg.family == "whisper":
        kw["frames"] = rng.normal(0, 1, (B, cfg.n_audio_ctx, cfg.d_model)
                                  ).astype("float32")
    elif cfg.n_patches:
        kw["prefix_embeds"] = rng.normal(0, 1, (B, cfg.n_patches,
                                                cfg.d_model)).astype("float32")
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype("int32")
    return toks, kw


def _jax_loss(cfg, model, toks, kw):
    """tests/test_archs_smoke.py's train-step loss."""
    def loss_fn(p):
        logits = model.forward(cfg, p, toks, **kw)
        lp = jax.nn.log_softmax(logits[:, : S - 1].astype(jnp.float32))
        return jnp.mean(-jnp.take_along_axis(lp, toks[:, 1:, None], axis=-1))
    return loss_fn


def _torch_loss(cfg, model, **fwd):
    def loss_fn(p, batch):
        toks = batch["tokens"]
        kw = {k: v for k, v in batch.items() if k != "tokens"}
        logits = model.forward(cfg, p, toks, **kw, **fwd)
        lp = torch.log_softmax(logits[:, : S - 1].to(torch.float32), -1)
        return torch.mean(-torch.gather(lp, -1,
                                        toks[:, 1:, None].to(torch.int64)))
    return loss_fn


def _vision_losses(cfg):
    imgs = np.random.default_rng(0).normal(
        0, 1, (2, cfg.img_res, cfg.img_res, 3)).astype("float32")
    labels = np.array([1, 2])
    jmodel, tmodel = jget_model(JREDUCED[EFFVIT]), tget_model(cfg)

    def jloss(p):
        lg = jmodel.forward(JREDUCED[EFFVIT], p, jnp.asarray(imgs)
                            ).astype(jnp.float32)
        return jnp.mean(-jax.nn.log_softmax(lg)[jnp.arange(2), labels])

    def tloss(p, _):
        lg = tmodel.forward(cfg, p, torch.from_numpy(imgs), attn="f32"
                            ).to(torch.float32)
        return torch.mean(-torch.log_softmax(lg, -1)[torch.arange(2),
                                                     torch.from_numpy(labels)])
    return jloss, tloss


def _grad_case(name):
    jcfg, tcfg = JREDUCED[name], TREDUCED[name]
    jp = jget_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax_to_numpy(jp), "cpu")
    if name == EFFVIT:
        jloss, tloss = _vision_losses(tcfg)
        batch = {}
    else:
        toks, kw = _inputs(jcfg)
        jloss = _jax_loss(jcfg, jget_model(jcfg), jnp.asarray(toks),
                          {k: jnp.asarray(v) for k, v in kw.items()})
        tloss = _torch_loss(tcfg, tget_model(tcfg))
        batch = {"tokens": torch.from_numpy(toks),
                 **{k: torch.from_numpy(v) for k, v in kw.items()}}
    return jp, tp, jloss, tloss, batch


@pytest.mark.parametrize("name", list(ASSIGNED) + [EFFVIT])
def test_gradients_match_jax(name):
    jp, tp, jloss, tloss, batch = _grad_case(name)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    tl, tg = value_and_grad(tloss, tp, batch)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    got, want = dict(leaves_with_path(params_to_numpy(tg))), \
        dict(leaves_with_path(jax_to_numpy(jg)))
    assert got.keys() == want.keys()
    for k in want:
        assert np.isfinite(got[k]).all(), k
        tol = 1e-4 * max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max()) if want[k].size else 0.0
        assert err <= tol, (name, k, err, tol)


# ---------------------------------------------------------------------------
# rematerialisation
# ---------------------------------------------------------------------------

REMAT = [("qwen1.5-0.5b", "full"), ("qwen1.5-0.5b", "dots"),
         ("llama4-scout-17b-a16e", "full"), ("rwkv6-3b", "full"),
         ("recurrentgemma-9b", "full"), ("whisper-large-v3", "full")]


def _remat_kw(name, policy, on):
    kw = {"remat": on}
    if TREDUCED[name].family in ("dense_lm", "moe_lm"):
        kw["remat_policy"] = policy
    return kw


@pytest.mark.parametrize("name,policy", REMAT)
def test_remat_leaves_gradients_and_inference_as_they_are(name, policy,
                                                          monkeypatch):
    _, tp, _, _, batch = _grad_case(name)
    cfg = TREDUCED[name]
    model = tget_model(cfg)
    on = value_and_grad(_torch_loss(cfg, model, **_remat_kw(name, policy,
                                                            True)), tp, batch)
    off = value_and_grad(_torch_loss(cfg, model, **_remat_kw(name, policy,
                                                             False)), tp,
                         batch)
    assert float(on[0]) == float(off[0])
    a, b = dict(leaves_with_path(on[1])), dict(leaves_with_path(off[1]))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    # under no_grad: no checkpoint at all, the same logits
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    toks = batch["tokens"]
    kw = {k: v for k, v in batch.items() if k != "tokens"}
    with torch.no_grad():
        x = model.forward(cfg, tp, toks, **kw,
                          **_remat_kw(name, policy, True))
        y = model.forward(cfg, tp, toks, **kw,
                          **_remat_kw(name, policy, False))
    assert not calls
    torch.testing.assert_close(x, y, rtol=0, atol=0)
    # while autograd records, one checkpoint per layer
    model.forward(cfg, tp, toks, **kw, **_remat_kw(name, policy, True))
    assert len(calls) == cfg.n_layers


def test_dense_forward_equals_the_per_layer_slices():
    """``layer_stack``'s unbound views run what ``layer_params`` slices
    run: the logits of the plain slice loop, bit for bit."""
    cfg = TREDUCED["qwen3-14b"]
    params = dense_lm.init(cfg, seed=3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    with torch.no_grad():
        got = dense_lm.forward(cfg, params, toks)
        x = dense_lm._embed(cfg, params, toks)
        pos = torch.arange(x.shape[1])[None, :]
        for i in range(cfg.n_layers):
            x = dense_lm.block(cfg, dense_lm.layer_params(params["layers"],
                                                          i), x, pos)
        want = dense_lm.nn.dense(dense_lm.nn.rms_norm(
            x, params["final_norm"]), params["lm_head"])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    layers = dense_lm.layer_stack(params["layers"], cfg.n_layers)
    for i, lp in enumerate(layers):
        ref = dense_lm.layer_params(params["layers"], i)
        for (k, a), (_, b) in zip(leaves_with_path(lp),
                                  leaves_with_path(ref)):
            assert a.data_ptr() == b.data_ptr() and a.shape == b.shape, k


def test_remat_policy_is_checked():
    with pytest.raises(ValueError, match="remat policy"):
        dense_lm.nn.remat(lambda x: x * 2, torch.ones(2, requires_grad=True),
                          policy="everything")
