"""Two-level mixed quantization (M2Q): quantizers, storage layouts,
QTensor leaves, calibration, Eq. 6 scheme selection, policy, apply."""
from .quant import (
    act_scale_from_stats,
    apot_codebook,
    apot_dequantize,
    apot_quantize,
    fake_quant_act,
    fake_quant_apot,
    fake_quant_pot,
    fake_quant_uniform,
    filterwise_mse,
    pot_dequantize,
    pot_quantize,
    quantize_act,
    uniform_dequantize,
    uniform_quantize,
)
from .scheme_select import SchemeAssignment, select_schemes
from .apply import fake_quant_model, quantize_model

__all__ = [
    "act_scale_from_stats", "apot_codebook", "apot_dequantize",
    "apot_quantize", "fake_quant_act", "fake_quant_apot", "fake_quant_pot",
    "fake_quant_uniform", "filterwise_mse", "pot_dequantize", "pot_quantize",
    "quantize_act", "uniform_dequantize", "uniform_quantize",
    "SchemeAssignment", "select_schemes", "fake_quant_model",
    "quantize_model",
]
