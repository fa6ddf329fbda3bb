"""The hot-path walk behind the offline autotune sweep (twin of
``repro.analysis.traces``'s ``registry_trace_specs`` and
``shape_requests``; the qlint traces wait for ROADMAP A10d).

JAX lowers each hot path with ``autotune.record_requests`` listening:
block choices resolve at trace time, so lowering alone walks every
``blocks_for`` call.  The port has no lowering, so it runs each hot path
eagerly on the deployment's device instead, with every dispatch axis on
and inside ``autotune.no_tuning()``: every ``*_op`` entry point asks the
autotuner for its plan before it launches (or, on a CPU tensor, before it
picks the plain version), so the walk records each launch shape, and
nothing is timed.

A deployment is a registry config quantized under a recipe.  Vision
configs run ``forward`` at each ``VisionEngine`` bucket (the powers of
two up to ``max_batch``).  Token configs (with the int8 KV cache where
the family's cache has one) are quantized at the decode shape (the
recipe's own tokens a step, from its calibration batch) and at
``LM_PREFILL_TOKENS`` tokens a step (the mixed LM on the prefill side;
``chip_smoke.py``'s ``token`` and ``token-m2q`` paths), and each tree
runs one prefill group of ``max_batch`` prompts of ``prefill_len`` tokens
and one decode step at ``(max_batch, max_len)``, the token Engine's
shapes.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import torch

from ..configs.registry import ARCHS, REDUCED
from ..kernels import autotune, ops
from ..models import get_model
from ..recipe import PRESETS, QuantizedModel, quantize
from ..serving.batching import pow2_bucket

LM_PREFILL_TOKENS = 64

Spec = Tuple[str, Callable[[], object]]


def _int8_kv(cfg):
    """``cfg`` with the int8 KV cache where the family's cache honors it
    (JAX's ``_int8_kv_cfg``), else ``cfg``."""
    cfg8 = cfg.replace(kv_cache_dtype="int8")
    cache = get_model(cfg8).init_cache(cfg8, 2, 16, device="meta")
    return cfg8 if any(t.dtype == torch.int8 for t in cache.values()) \
        else cfg


def model_trace_specs(qm: QuantizedModel, label: str, *, max_batch: int = 8,
                      prefill_len: int = 128,
                      max_len: int = 256) -> List[Spec]:
    """``(name, fn)`` for the hot paths of one quantized model on its
    device: ``fn()`` runs one eagerly."""
    cfg, dev = qm.cfg, qm.device
    if cfg.family == "efficientvit":
        buckets = sorted({pow2_bucket(n, 1, max_batch)
                          for n in range(1, max_batch + 1)})

        def forward(b):
            return lambda: qm.forward(torch.zeros(
                (b, cfg.img_res, cfg.img_res, 3), device=dev))

        return [(f"{label}/forward_b{b}", forward(b)) for b in buckets]
    model = qm.model
    gen = torch.Generator(device="cpu").manual_seed(0)

    def prefill():
        toks = torch.randint(0, cfg.vocab_size, (max_batch, prefill_len),
                             generator=gen).to(dev)
        cache = model.init_cache(cfg, max_batch, max_len,
                                 dtype=torch.float32, device=dev)
        kw = ({"lengths": torch.full((max_batch,), prefill_len,
                                     dtype=torch.int32, device=dev)}
              if getattr(model, "RAGGED_PREFILL", False) else {})
        with torch.inference_mode():
            return model.prefill(cfg, qm.params, cache, toks, **kw)

    def decode():
        cache = model.init_cache(cfg, max_batch, max_len,
                                 dtype=torch.float32, device=dev)
        cache["lengths"].fill_(prefill_len)
        toks = torch.randint(0, cfg.vocab_size, (max_batch, 1),
                             generator=gen).to(dev)
        with torch.inference_mode():
            return model.decode_step(cfg, qm.params, cache, toks)

    return [(f"{label}/prefill", prefill), (f"{label}/decode", decode)]


def registry_deployments(arch: str, *, recipes: Sequence[str] = (
        "m2q-w8a8", "uniform8"), device="cuda",
        reduced: bool = False) -> Iterator[Tuple[str, QuantizedModel]]:
    """``(label, quantized model)`` for one registry config (published
    widths, or its REDUCED twin): the float tree built once on ``device``
    from seed 0, quantized per recipe and, for token configs, per
    deployment shape (labelled ``<arch>/<recipe>`` and
    ``<arch>/<recipe>@<tokens a step>``)."""
    cfg = (REDUCED if reduced else ARCHS)[arch]
    if cfg.family != "efficientvit":
        cfg = _int8_kv(cfg)
    params = get_model(cfg).init(cfg, seed=0, device=device)
    shapes = ((None,) if cfg.family == "efficientvit"
              else (None, LM_PREFILL_TOKENS))
    for name in recipes:
        for tps in shapes:
            rec = PRESETS[name] if tps is None \
                else PRESETS[name].replace(tokens_per_step=tps)
            label = f"{arch}/{name}" + ("" if tps is None else f"@{tps}")
            yield label, quantize(cfg, params, rec)


def registry_trace_specs(arch: str, *, recipes: Sequence[str] = (
        "m2q-w8a8", "uniform8"), device="cuda",
        reduced: bool = False) -> Iterator[Spec]:
    """The trace set of one registry config: :func:`model_trace_specs` of
    each of its :func:`registry_deployments`."""
    for label, qm in registry_deployments(arch, recipes=recipes,
                                          device=device, reduced=reduced):
        yield from model_trace_specs(qm, label)


def walk(specs) -> Tuple[List[autotune.ShapeRequest], Dict[str, int]]:
    """Run each spec with every dispatch axis on, recording and never
    timing: (the deduplicated requests in first-seen order, {trace name:
    requests recorded})."""
    reqs: List[autotune.ShapeRequest] = []
    per_trace: Dict[str, int] = {}
    for name, fn in specs:
        n0 = len(reqs)
        with autotune.record_requests(reqs), autotune.no_tuning(), \
                ops.dispatch(dense=True, conv=True, attn=True):
            fn()
        per_trace[name] = len(reqs) - n0
    return list(dict.fromkeys(reqs)), per_trace


def shape_requests(configs: Sequence[str], *,
                   recipes: Sequence[str] = ("m2q-w8a8", "uniform8"),
                   device="cuda", reduced: bool = False):
    """Every autotune shape a deployment's hot paths request:
    ``(requests, per_trace)`` as :func:`walk` returns them, over
    :func:`registry_trace_specs` of each config."""
    def specs():
        for arch in configs:
            yield from registry_trace_specs(arch, recipes=recipes,
                                            device=device, reduced=reduced)
    # quantizing calibrates through eager forwards: nothing tunes there
    # either
    with autotune.no_tuning():
        return walk(specs())
