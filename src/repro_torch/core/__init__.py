"""Two-level mixed quantization (M2Q): quantizers, storage layouts,
QTensor leaves, calibration, Eq. 6 scheme selection, policy, apply."""
