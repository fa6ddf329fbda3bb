"""One-call quantization API (twin of ``repro.recipe``):
``QuantRecipe`` -> ``QuantizedModel``.

    from repro_torch.recipe import quantize
    qm = quantize("efficientvit-b1-r224", params, "m2q-w8a8")
    logits = qm.forward(images)
    engine = qm.serve(max_batch=8)          # VisionEngine

    cfg = ARCHS["qwen1.5-0.5b"].replace(kv_cache_dtype="int8")
    qm = quantize(cfg, dense_lm.init(cfg), "m2q-w8a8")
    engine = qm.serve(max_batch=8, max_len=256)   # token Engine

PTQ activation calibration -> Eq. 6 scheme selection -> mixed-scheme /
mixed-precision quantization.  Presets: ``m2q-w8a8`` (the paper's flow),
``uniform8`` (W8A8 uniform everywhere) and ``w4-weights-only``; any other
:class:`QuantRecipe` is built from its fields (the opt-in int8 stem appends
``efficientvit.STEM_RULE`` / ``STEM_OVERRIDE``; a weights-only APoT recipe is
``M2QPolicy(compute_scheme="apot", quantize_activations=False)``).

    qm.save("ckpts/b1-m2q")                  # persist: never re-quantizes
    qm2 = QuantizedModel.load("ckpts/b1-m2q")   # on the card; device="cpu"

The artifact is the JAX package's format (``ckpt.checkpoint``: npz +
manifest, the same leaf keys and provenance), so either package loads the
other's.  ``load`` rebuilds the tree's structure from the shape-only twin
:func:`abstract_quantize` -- data-dependent Eq. 6 splits come from the
saved reports -- and never touches float weights.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .ckpt import checkpoint as ckpt
from .core import policy as pol
from .core.apply import (LayerReport, Override, Rule, abstract_quantize_model,
                         quantize_model)
from .core.calibrate import rule_matcher, run_calibration, wrap_for_calibration
from .core.policy import M2QPolicy, PathOverride, ShapeCtx
from .core.tree import device_of
from .models import FAMILIES, get_model
from .models.config import ArchConfig


# families whose calibration inputs quantize() can synthesize on its own
_TOKEN_FAMILIES = ("dense_lm", "moe_lm", "rwkv", "recurrentgemma")

# families whose forward the reference's calibration cannot run (JAX
# runs it unjitted and unrolled, with CalibTensor leaves), and why
_UNCALIBRATABLE = {
    "recurrentgemma": "its forward reshapes the stacked 'rec' leaves into "
                      "(rec, rec, attn) groups, and JAX's calibration "
                      "forward raises AttributeError: 'CalibTensor' object "
                      "has no attribute 'reshape'",
    "whisper": "its encode runs jax.lax.scan over the stacked enc_layers "
               "(unroll reaches only the decoder), and JAX's calibration "
               "forward raises TypeError: a CalibTensor is not a valid JAX "
               "type",
}


@dataclasses.dataclass(frozen=True)
class CalibSpec:
    """Synthesized calibration from numpy's generator seeded with
    ``seed``: ``batches`` random (batch_size, seq_len) prompts for token
    families, (batch_size, res, res, 3) images for the vision family.
    ``batch_size`` also seeds the default deployment ShapeCtx."""

    batches: int = 4
    batch_size: int = 2
    seq_len: int = 32
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class QuantRecipe:
    """One quantization run.  ``rules`` / ``ffn_groups`` default to the
    model's QUANT_RULES / FFN_FOLD_GROUPS; ``overrides`` are ordered
    ``(path regex, PathOverride)`` pairs consulted before the arch's
    (first match wins); ``tokens_per_step`` fixes the deployment ShapeCtx
    (None: derived from the calibration batches -- vision: batch * res^2
    pixels; LM: the decode batch)."""

    name: str = "m2q-w8a8"
    policy: M2QPolicy = M2QPolicy()
    rules: Optional[Tuple[Rule, ...]] = None
    ffn_groups: Optional[Tuple[tuple, ...]] = None
    overrides: Tuple[Override, ...] = ()
    calib: CalibSpec = CalibSpec()
    tokens_per_step: Optional[int] = None

    def replace(self, **kw) -> "QuantRecipe":
        return dataclasses.replace(self, **kw)

    def validate(self, abstract: bool = False) -> None:
        """Fail fast on what cannot be done.  ``abstract``: the caller
        wants the shape-only twin, which cannot know the data-dependent
        split of ``apot_ratio=None`` (the Eq. 6 argmin) without per-layer
        split hints."""
        if self.policy.compute_scheme not in ("m2q", "uniform8", "apot"):
            raise ValueError(
                f"recipe {self.name!r}: unknown compute_scheme "
                f"{self.policy.compute_scheme!r}")
        if abstract and self.policy.compute_scheme == "m2q" \
                and self.policy.apot_ratio is None:
            raise ValueError(
                f"recipe {self.name!r}: apot_ratio=None (Eq. 6 argmin) has "
                "a data-dependent split and cannot produce an abstract "
                "twin; use a fixed apot_ratio, or quantize concretely and "
                "rebuild the tree from the artifact's saved LayerReports "
                "(QuantizedModel.abstract_params does this)")

    def resolve(self, cfg: ArchConfig) -> "ResolvedRecipe":
        """Bind the recipe to one architecture: the model's rules and FFN
        groups unless the recipe names its own, recipe overrides before
        the arch's, and the deployment ShapeCtx."""
        model = get_model(cfg)
        rules = tuple(self.rules if self.rules is not None
                      else model.QUANT_RULES)
        ffn_groups = self.ffn_groups
        if ffn_groups is None:
            ffn_groups = tuple(getattr(model, "FFN_FOLD_GROUPS", ()) or ())
        overrides = tuple(self.overrides) + _arch_overrides(cfg, model, rules)
        toks = self.tokens_per_step
        if toks is None:
            toks = _default_tokens_per_step(cfg, self.calib.batch_size)
        ctx = ShapeCtx(tokens_per_step=toks,
                       moe_top_k=max(cfg.moe_top_k, 1),
                       moe_num_experts=max(cfg.moe_experts, 1))
        return ResolvedRecipe(recipe=self, cfg=cfg, rules=rules,
                              ffn_groups=ffn_groups, overrides=overrides,
                              shape_ctx=ctx)


@dataclasses.dataclass(frozen=True)
class ResolvedRecipe:
    """A QuantRecipe bound to one ArchConfig (all defaults filled in)."""

    recipe: QuantRecipe
    cfg: ArchConfig
    rules: Tuple[Rule, ...]
    ffn_groups: Tuple[tuple, ...]
    overrides: Tuple[Override, ...]
    shape_ctx: ShapeCtx

    @property
    def policy(self) -> M2QPolicy:
        return self.recipe.policy


def taxonomy_overrides(rules: Sequence[Rule]) -> Tuple[Override, ...]:
    """decision=mixed overrides for every compute-kind rule pattern: pins
    the paper's structural taxonomy (PWConv/MatMul -> mixed) however far
    the deployment shape sits below the intensity threshold."""
    return tuple(
        (rx, PathOverride(decision=pol.DECISION_MIXED))
        for rx, kind in rules
        if kind in (pol.KIND_DENSE, pol.KIND_HEAD, pol.KIND_EXPERT))


def _default_tokens_per_step(cfg: ArchConfig, batch: int) -> int:
    if cfg.family == "efficientvit":
        return batch * cfg.img_res * cfg.img_res  # pixels through a PWConv
    return batch  # decode deployment shape (batch tokens per step)


def _arch_overrides(cfg: ArchConfig, model, rules) -> Tuple[Override, ...]:
    """The model's QUANT_OVERRIDES when it declares them (efficientvit
    pins the paper taxonomy); else, for a narrow LM (d_model <= 256) whose
    every matmul is memory-bound, :func:`taxonomy_overrides`, so the mixed
    path is exercised at demo sizes."""
    declared = getattr(model, "QUANT_OVERRIDES", None)
    if declared is not None:
        return tuple(declared)
    if cfg.family != "efficientvit" and 0 < cfg.d_model <= 256:
        return taxonomy_overrides(rules)
    return ()


PRESETS: Dict[str, QuantRecipe] = {
    # the paper's two-level flow: mixed uniform8/APoT on compute-intensive
    # weights, 4-bit uniform on memory-intensive ones, W8A8 integer path
    "m2q-w8a8": QuantRecipe(name="m2q-w8a8", policy=M2QPolicy()),
    # single-scheme uniform W8A8 everywhere (the Trio-ViT baseline row)
    "uniform8": QuantRecipe(
        name="uniform8",
        policy=M2QPolicy(compute_scheme="uniform8", memory_bits=8)),
    # weights-only 4-bit: no activation quantization, every quantizable
    # weight low-bit regardless of intensity
    "w4-weights-only": QuantRecipe(
        name="w4-weights-only",
        policy=M2QPolicy(memory_bits=4, quantize_activations=False),
        overrides=((r".", PathOverride(decision=pol.DECISION_LOWBIT)),)),
}


def as_recipe(recipe: Union[str, QuantRecipe]) -> QuantRecipe:
    if isinstance(recipe, QuantRecipe):
        return recipe
    if recipe not in PRESETS:
        raise KeyError(f"unknown recipe preset {recipe!r}; available: "
                       f"{sorted(PRESETS)}")
    return PRESETS[recipe]


def resolve_cfg(arch_or_cfg) -> ArchConfig:
    if isinstance(arch_or_cfg, ArchConfig):
        return arch_or_cfg
    from .configs.registry import ARCHS, REDUCED
    if arch_or_cfg in ARCHS:
        return ARCHS[arch_or_cfg]
    by_reduced_name = {c.name: c for c in REDUCED.values()}
    if arch_or_cfg in by_reduced_name:
        return by_reduced_name[arch_or_cfg]
    raise KeyError(f"unknown arch {arch_or_cfg!r}")


def synth_calib_batches(cfg: ArchConfig, spec: CalibSpec) -> List[np.ndarray]:
    """The JAX package's synthesized calibration batches: random images
    for the vision family, random token prompts for token families."""
    rng = np.random.default_rng(spec.seed)
    if cfg.family == "efficientvit":
        return [rng.normal(0, 1, (spec.batch_size, cfg.img_res, cfg.img_res,
                                  3)).astype(np.float32)
                for _ in range(spec.batches)]
    if cfg.family in _TOKEN_FAMILIES:
        return [rng.integers(0, cfg.vocab_size,
                             (spec.batch_size, spec.seq_len), dtype=np.int32)
                for _ in range(spec.batches)]
    raise ValueError(f"cannot synthesize calibration inputs for family "
                     f"{cfg.family!r}; pass explicit calib_batches")


@dataclasses.dataclass
class QuantizedModel:
    """The result of one :func:`quantize` call: the QTensor parameter tree,
    per-layer reports, the recipe and the activation-stats provenance."""

    cfg: ArchConfig
    recipe: QuantRecipe
    params: object
    report: List[LayerReport]
    act_stats: Dict[str, float]
    provenance: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def model(self):
        return get_model(self.cfg)

    @property
    def device(self) -> torch.device:
        return device_of(self.params)

    def forward(self, inputs, attn: Optional[str] = None,
                **kw) -> torch.Tensor:
        """One forward pass, tensor or numpy inputs: images (B, res, res,
        3) -> logits, ``attn`` the MSA token mixer; or tokens (B, S) ->
        (B, S, padded_vocab) logits, ``kw`` the model's own inputs as
        JAX's ``forward`` passes them (whisper's ``frames=`` / ``memory=``,
        internvl2's ``prefix_embeds=``)."""
        x = torch.as_tensor(inputs, device=self.device)
        kw = {k: None if v is None else torch.as_tensor(v, device=self.device)
              for k, v in kw.items()}
        with torch.inference_mode():
            return _model_forward(self.cfg, self.model, self.params, x,
                                  attn, **kw)

    def serve(self, dispatch=None, mesh=None, **engine_kw):
        """The serving engine for this model, by modality: the batched
        :class:`~repro_torch.serving.vision.VisionEngine` for the vision
        family (``max_batch``, ``min_bucket``, ``max_delay_ms``, ``attn``,
        ...), the continuous-batching token
        :class:`~repro_torch.serving.engine.Engine` otherwise
        (``max_batch``, ``max_len``, ``seed``, ``max_delay_ms``, ...).
        ``dispatch``: an optional ``kernels.ops.DispatchConfig`` the
        engine enters inside every step and capture.  ``mesh``: an
        optional ``("data", "model")`` ``DeviceMesh`` for sharded
        execution (both engines' ``mesh=``; on more than one rank pass
        ``graphs=False``)."""
        if self.cfg.family == "efficientvit":
            from .serving.vision import VisionEngine
            return VisionEngine(self.cfg, self.params, dispatch=dispatch,
                                mesh=mesh, **engine_kw)
        from .serving.engine import Engine
        return Engine(self.cfg, self.params, dispatch=dispatch, mesh=mesh,
                      **engine_kw)

    def m2q_splits(self) -> Dict[str, Tuple[int, int]]:
        """path -> (n_uniform, n_apot) from the reports: what lets the
        abstract twin repeat data-dependent Eq. 6 splits exactly."""
        return {r.path: (r.n_uniform, r.n_apot) for r in self.report
                if r.n_uniform or r.n_apot}

    def abstract_params(self):
        """The shape-only twin of ``params`` (``meta`` fields; the load
        template): activation scales where calibration recorded stats, the
        reports' m2q splits."""
        with_act = bool(self.act_stats) and \
            self.recipe.policy.quantize_activations
        return abstract_quantize(self.cfg, recipe=self.recipe,
                                 with_act_scales=with_act,
                                 m2q_splits=self.m2q_splits())

    def save(self, path, step: int = 0):
        """Atomic checkpoint of the QTensor tree with the JSON provenance
        (the JAX package's ``extra`` keys); returns the step directory."""
        extra = {
            "kind": "quantized_model",
            "cfg": _cfg_to_json(self.cfg),
            "recipe": _recipe_to_json(self.recipe),
            "report": [_report_to_json(r) for r in self.report],
            "act_stats": {k: float(v) for k, v in self.act_stats.items()},
            "provenance": self.provenance,
        }
        return ckpt.save(path, step, self.params, extra=extra)

    @classmethod
    def load(cls, path, step: Optional[int] = None,
             device="cuda", shardings=None) -> "QuantizedModel":
        """The artifact at ``path`` (the latest step unless ``step``),
        written by either package, on ``device``, without re-quantizing:
        the abstract twin gives the structure, the checkpoint the bytes
        (each leaf's SHA256, shape and dtype checked).  ``shardings``: a
        callable taking the abstract tree and returning its
        ``NamedSharding`` tree (e.g. ``lambda t:
        shardings_from_specs(param_specs(t, mesh), mesh)``), or that tree
        itself -- each leaf is placed as a ``DTensor`` on this rank
        (``ckpt.restore(..., shardings=)``)."""
        if step is None:
            step = ckpt.latest_step(path)
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {path!r}")
        probe = ckpt.read_extra(path, step)
        if probe.get("kind") != "quantized_model":
            raise ValueError(f"{path!r} is not a QuantizedModel checkpoint")
        out = cls(cfg=_cfg_from_json(probe["cfg"]),
                  recipe=_recipe_from_json(probe["recipe"]), params=None,
                  report=[_report_from_json(r) for r in probe["report"]],
                  act_stats=dict(probe["act_stats"]),
                  provenance=dict(probe.get("provenance", {})))
        template = out.abstract_params()
        if callable(shardings):
            shardings = shardings(template)
        out.params, _ = ckpt.restore(path, step, template, device=device,
                                     shardings=shardings)
        return out


def _model_forward(cfg: ArchConfig, model, params, x, attn: Optional[str],
                   **kw):
    if cfg.family == "efficientvit":
        return model.forward(cfg, params, x, attn=attn, **kw)
    return model.forward(cfg, params, x, **kw)


def quantize(arch_or_cfg, params, recipe: Union[str, QuantRecipe] = "m2q-w8a8",
             calib_batches: Optional[Iterable] = None,
             attn: Optional[str] = None,
             release: bool = False) -> QuantizedModel:
    """Calibrate -> scheme-select -> quantize, in one call, on the device
    the float ``params`` live on.  ``calib_batches``: model inputs (numpy
    or tensors: images, or token prompts); None synthesizes them per the
    recipe's CalibSpec; weights-only recipes skip calibration.  ``attn``:
    the vision MSA token mixer used during calibration (the attn dispatch
    axis when None).  ``release``: the caller hands ``params`` over --
    each quantized leaf's float weight is dropped from it as soon as its
    QTensor exists (``core.apply.quantize_model``), so a float tree that
    fills most of the card (qwen3-14b's 59 GB) quantizes there; the
    numbers are the same either way."""
    cfg = resolve_cfg(arch_or_cfg)
    rec = as_recipe(recipe)
    rec.validate()
    resolved = rec.resolve(cfg)
    model = get_model(cfg)
    device = device_of(params)

    act_stats: Dict[str, float] = {}
    n_calib = 0
    if rec.policy.quantize_activations and cfg.family in _UNCALIBRATABLE:
        raise NotImplementedError(
            f"recipe {rec.name!r} calibrates activations, which "
            f"{cfg.family!r} cannot do in the reference either: "
            f"{_UNCALIBRATABLE[cfg.family]}; use a weights-only recipe "
            "(w4-weights-only)")
    if rec.policy.quantize_activations:
        if calib_batches is None:
            calib_batches = synth_calib_batches(cfg, rec.calib)
        calib_batches = [torch.as_tensor(b, device=device)
                         for b in calib_batches]
        n_calib = len(calib_batches)
        # the deployment shape of the real batches, unless the recipe
        # pins one
        if rec.tokens_per_step is None and calib_batches:
            resolved = dataclasses.replace(
                resolved, shape_ctx=dataclasses.replace(
                    resolved.shape_ctx,
                    tokens_per_step=_default_tokens_per_step(
                        cfg, int(calib_batches[0].shape[0]))))
        wrapped, act_stats = wrap_for_calibration(
            params, rule_matcher(resolved.rules))
        run_calibration(
            lambda p, b: _model_forward(cfg, model, p, b, attn), wrapped,
            calib_batches)
        del wrapped, calib_batches  # no reference to the float leaves

    qparams, report = quantize_model(
        params, resolved.rules, resolved.shape_ctx, rec.policy,
        act_stats=act_stats, ffn_groups=resolved.ffn_groups or None,
        overrides=resolved.overrides, release=release)
    toks = resolved.shape_ctx.tokens_per_step
    return QuantizedModel(
        cfg=cfg, recipe=rec.replace(tokens_per_step=toks), params=qparams,
        report=report, act_stats=dict(act_stats),
        provenance={"calib_batches": n_calib, "calib_sites": len(act_stats),
                    "tokens_per_step": toks})


def abstract_quantize(arch_or_cfg, params_abs=None,
                      recipe: Union[str, QuantRecipe] = "m2q-w8a8",
                      tokens_per_step: Optional[int] = None,
                      with_act_scales: bool = True,
                      m2q_splits: Optional[Dict[str, Tuple[int, int]]] = None):
    """Shape-only twin of :func:`quantize` (artifact load templates): the
    QTensor tree for ``arch_or_cfg`` under ``recipe`` with ``meta``
    fields.  ``params_abs`` defaults to the float tree on the meta device
    (``init(cfg, device="meta")``, the twin of ``jax.eval_shape`` of init:
    nothing is allocated); ``m2q_splits`` (path -> (n_uniform, n_apot),
    e.g. from saved LayerReports) makes data-dependent Eq. 6 splits
    representable -- without them ``apot_ratio=None`` is rejected."""
    cfg = resolve_cfg(arch_or_cfg)
    rec = as_recipe(recipe)
    if tokens_per_step is not None:
        rec = rec.replace(tokens_per_step=tokens_per_step)
    rec.validate(abstract=m2q_splits is None)
    resolved = rec.resolve(cfg)
    if params_abs is None:
        params_abs = get_model(cfg).init(cfg, device="meta")
    return abstract_quantize_model(
        params_abs, resolved.rules, resolved.shape_ctx, resolved.policy,
        with_act_scales=with_act_scales,
        ffn_groups=resolved.ffn_groups or None,
        overrides=resolved.overrides, m2q_splits=m2q_splits)


# ---------------------------------------------------------------------------
# JSON (de)serialisation of the provenance payload (the JAX package's)
# ---------------------------------------------------------------------------

# The JAX package's ArchConfig fields the port's lacks, with their JAX
# defaults.  FUNCTION_FIELDS change what the model computes (bf16
# attention dots) or may one day (``block_pattern``, which no JAX model
# reads): a value other than the default names a model the port cannot
# run, and loading it raises.  EXECUTION_FIELDS only steer how JAX
# executes (scans, remat, sharding) and are dropped.
FUNCTION_FIELDS = {"block_pattern": (), "attn_bf16_mm": False}
EXECUTION_FIELDS = {"causal_skip": False, "act_sharding": "",
                    "remat_policy": "full"}


class UnsupportedConfigError(ValueError):
    """An artifact's config names a model the port does not run."""


def _cfg_to_json(cfg: ArchConfig) -> dict:
    """The JAX package's ``dataclasses.asdict`` of the config: the port's
    fields, then the JAX-only ones at their defaults."""
    d = dataclasses.asdict(cfg)
    for k, v in {**FUNCTION_FIELDS, **EXECUTION_FIELDS}.items():
        d[k] = list(v) if isinstance(v, tuple) else v
    return d


def _cfg_from_json(d: dict) -> ArchConfig:
    """Inverse of :func:`_cfg_to_json` for either package's payload; raises
    :class:`UnsupportedConfigError` on a family the port lacks, a
    function-changing JAX field away from its default, or a field neither
    package knows."""
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {}
    for k, v in d.items():
        v = tuple(v) if isinstance(v, list) else v
        if k in fields:
            kw[k] = v
        elif k in FUNCTION_FIELDS:
            if v != FUNCTION_FIELDS[k]:
                raise UnsupportedConfigError(
                    f"config {d.get('name')!r}: {k}={v!r} changes the model "
                    f"the port would run (it has only {k}="
                    f"{FUNCTION_FIELDS[k]!r})")
        elif k not in EXECUTION_FIELDS:
            raise UnsupportedConfigError(
                f"config {d.get('name')!r}: unknown field {k!r}")
    if kw.get("family") not in FAMILIES:
        raise UnsupportedConfigError(
            f"config {d.get('name')!r}: family {kw.get('family')!r} is not "
            f"ported (ported: {sorted(FAMILIES)})")
    return ArchConfig(**kw)


def _recipe_to_json(rec: QuantRecipe) -> dict:
    return {
        "name": rec.name,
        "policy": dataclasses.asdict(rec.policy),
        "rules": None if rec.rules is None else [list(r) for r in rec.rules],
        "ffn_groups": None if rec.ffn_groups is None
        else [list(g) for g in rec.ffn_groups],
        "overrides": [[rx, dataclasses.asdict(ov)]
                      for rx, ov in rec.overrides],
        "calib": dataclasses.asdict(rec.calib),
        "tokens_per_step": rec.tokens_per_step,
    }


def _recipe_from_json(d: dict) -> QuantRecipe:
    return QuantRecipe(
        name=d["name"], policy=M2QPolicy(**d["policy"]),
        rules=None if d["rules"] is None
        else tuple(tuple(r) for r in d["rules"]),
        ffn_groups=None if d["ffn_groups"] is None
        else tuple(tuple(g) for g in d["ffn_groups"]),
        overrides=tuple((rx, PathOverride(**ov))
                        for rx, ov in d["overrides"]),
        calib=CalibSpec(**d["calib"]),
        tokens_per_step=d["tokens_per_step"])


def _report_to_json(r: LayerReport) -> dict:
    d = dataclasses.asdict(r)
    d["shape"] = list(d["shape"])
    return d


def _report_from_json(d: dict) -> LayerReport:
    d = dict(d)
    d["shape"] = tuple(d["shape"])
    return LayerReport(**d)
