"""One-call quantization API (twin of ``repro.recipe``):
``QuantRecipe`` -> ``QuantizedModel``.

    from repro_torch.recipe import quantize
    qm = quantize("efficientvit-b1-r224", params, "m2q-w8a8")
    logits = qm.forward(images)
    engine = qm.serve(max_batch=8)

PTQ activation calibration -> Eq. 6 scheme selection -> mixed-scheme /
mixed-precision quantization.  The ``m2q-w8a8`` preset is ported; the other
presets and ``save``/``load`` come with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from .core.apply import LayerReport, quantize_model
from .core.calibrate import rule_matcher, run_calibration, wrap_for_calibration
from .core.policy import M2QPolicy, ShapeCtx
from .core.tree import device_of
from .models import get_model
from .models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class CalibSpec:
    """Synthesized calibration: ``batches`` random (batch_size, res, res, 3)
    images from numpy's generator seeded with ``seed``."""

    batches: int = 4
    batch_size: int = 2
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class QuantRecipe:
    """One quantization run: the policy and the calibration spec.  The
    rules and per-path overrides are the model's QUANT_RULES and
    QUANT_OVERRIDES (recipe-level rules/overrides come with the opt-in int8
    stem)."""

    name: str = "m2q-w8a8"
    policy: M2QPolicy = M2QPolicy()
    calib: CalibSpec = CalibSpec()


PRESETS: Dict[str, QuantRecipe] = {
    # the paper's two-level flow: mixed uniform8/APoT on compute-intensive
    # weights, 4-bit uniform on memory-intensive ones, W8A8 integer path
    "m2q-w8a8": QuantRecipe(name="m2q-w8a8", policy=M2QPolicy()),
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


def _tokens_per_step(cfg: ArchConfig, batch: int) -> int:
    return batch * cfg.img_res * cfg.img_res  # pixels through a PWConv


def synth_calib_batches(cfg: ArchConfig, spec: CalibSpec) -> List[np.ndarray]:
    """The JAX package's synthesized vision calibration batches."""
    rng = np.random.default_rng(spec.seed)
    return [rng.normal(0, 1, (spec.batch_size, cfg.img_res, cfg.img_res, 3))
            .astype(np.float32) for _ in range(spec.batches)]


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

    def forward(self, images, attn: Optional[str] = None) -> torch.Tensor:
        """One forward pass; images (B, res, res, 3), tensor or numpy."""
        x = torch.as_tensor(images, device=self.device)
        with torch.inference_mode():
            return self.model.forward(self.cfg, self.params, x, attn=attn)

    def serve(self, **engine_kw):
        """A :class:`~repro_torch.serving.vision.VisionEngine` over this
        model (``max_batch``, ``max_delay_ms``, ``attn``, ... forward)."""
        if self.cfg.family != "efficientvit":
            raise NotImplementedError("only the vision engine is ported")
        from .serving.vision import VisionEngine
        return VisionEngine(self.cfg, self.params, **engine_kw)


def quantize(arch_or_cfg, params, recipe: Union[str, QuantRecipe] = "m2q-w8a8",
             calib_batches: Optional[Iterable] = None,
             attn: Optional[str] = None) -> QuantizedModel:
    """Calibrate -> scheme-select -> quantize, in one call, on the device
    the float ``params`` live on.  ``calib_batches``: model inputs (numpy
    or tensors); None synthesizes them per the recipe's CalibSpec.
    ``attn``: the MSA token mixer used during calibration (device
    default when None)."""
    cfg = resolve_cfg(arch_or_cfg)
    rec = as_recipe(recipe)
    model = get_model(cfg)
    device = device_of(params)
    toks = _tokens_per_step(cfg, rec.calib.batch_size)

    act_stats: Dict[str, float] = {}
    n_calib = 0
    if rec.policy.quantize_activations:
        if calib_batches is None:
            calib_batches = synth_calib_batches(cfg, rec.calib)
        calib_batches = [torch.as_tensor(b, device=device)
                         for b in calib_batches]
        n_calib = len(calib_batches)
        if calib_batches:  # the deployment shape of the real batches
            toks = _tokens_per_step(cfg, int(calib_batches[0].shape[0]))
        wrapped, act_stats = wrap_for_calibration(
            params, rule_matcher(model.QUANT_RULES))
        run_calibration(
            lambda p, b: model.forward(cfg, p, b, attn=attn), wrapped,
            calib_batches)

    qparams, report = quantize_model(
        params, model.QUANT_RULES, ShapeCtx(tokens_per_step=toks),
        rec.policy, act_stats=act_stats, overrides=model.QUANT_OVERRIDES)
    return QuantizedModel(
        cfg=cfg, recipe=rec, params=qparams,
        report=report, act_stats=dict(act_stats),
        provenance={"calib_batches": n_calib, "calib_sites": len(act_stats),
                    "tokens_per_step": toks})
